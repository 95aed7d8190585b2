"""Smoke run of deflate_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from deflate_tpu_torch/csrc/ (one nvcc per
source, all at once) and the native host library (g++), then drives
eight paths on an 8 MiB mixed corpus (256 blocks of 32 KiB), each with
every kernel count set to 0 just before it and read just after:

  A  level-2 ``compress_with_manifest`` (K10, K9, K1), then hinted
     ``decode_all`` on the card (K2-K4, K11, K12);
  B  a foreign stream (python zlib, level 6, raw) through
     ``decompress(device=cuda, force_device=True)``: the skeleton walk,
     then the wavefront decoder with history (K2, K3, K5; K11 and K12
     once a group of virtual blocks); and the same
     call without force_device, which the dispatcher redirects to the
     host decoder;
  C  ``compress_with_manifest(hints=False)``, then ``decode_all`` on the
     card: every block through the full block inflate (K6);
  D  level 3: ``compress_with_manifest(level=3)`` (K10 on three hash
     passes, K9 at tile 2048, K1); then stage C alone on the level-3
     plans of the same blocks, ``encoder.emit_block`` (the merge
     placement every encode path runs) against
     ``encoder.emit_block_packed`` (packet fusion, compaction on K3,
     placement on K7, on no encode path): the words must be identical;
  E  hinted ``decode_all`` of D's stream with DT_STAGEAB_PALLAS=0: stage
     A at every bit phase on K8, the mark automaton in torch, K3, K4 —
     and K2 not at all;
  F  the speculative decoder (models/decoder.py, torch array code, no
     kernel of its own) on the card: the inputs of speculative_cases()
     through ``decompress(force_device=True)`` — a 50,000-byte stored
     block, corrupt streams (InflateError after both capacity
     configurations flag them, the only calls of the host decoder) and
     wrong out_size values — then phase A's stream through
     ``decoder.inflate_device`` (256 blocks, max_blocks 512);
  G  the public encode entry points (K9, K1): ``compress(data, 2)``, in
     segments of 64 blocks stitched on the host, must equal phase A's
     stream; ``compress(stats=...)`` (a second, size-only planning pass,
     K1 again); ``compress_many`` of the corpus's quarters must equal
     ``compress`` of each; ``compress_file`` at its default chunk_blocks
     must equal ``compress``; ``compress_zlib`` and ``compress_gzip``
     must round-trip through python zlib and gzip; ``decompress_gzip``
     of a two-member python gzip file; ``decompress_file`` (host) of a
     1 MiB prefix's stream; ``decode_range`` on three ranges of phase
     A's manifest; ``backend="native"`` and ``"auto"`` on 10,000 bytes;
  H  data parallelism (parallel/mesh.py) on a world of one over NCCL,
     started by ``make_mesh`` through a FileStore in a temporary
     directory: ``compress_mesh`` (K1) must equal phase A's stream;
     ``decompress_mesh`` of A's stream and v2 manifest takes the
     wavefront route (``decode_mesh_wave``: K2, K3, K4, one window size
     for all 256 rows) and of the first 64 blocks of C's hintless
     manifest the scan route (``decode_block_standalone``, torch code);
     a corrupted copy of A's stream (corrupt_block3) must raise
     ValueError; ``entry.dryrun_multichip(1)`` must pass its checks.

Phases A, B and E parse block headers with the native walk
(``ops/wave.parse_headers_host``); on phase A's and B's offsets it is
held against the Python walk, and both are timed.

Each phase checks its output against the input and that its kernels
launched.  Then each kernel is held against its plain PyTorch version on
the card, on operands its phase gave it, and both are timed with CUDA
events; the line of kernel results adds each kernel's bound (bytes moved
over 3.35 TB/s) and, for K3 and K7, one PyTorch scatter of the same
work (K7's: an index_add_ of only the live packets' nonzero words, with
the older scatter_add_ of all lanes beside it as library_all_lanes_ms);
K1's, K2's, K3's and K7's also get the time of their C entry point
alone (kernel_only_ms), K2's its ns per chain step and K8's its ns per
position; K2 (on every call of phases A and B), K4, K5 (on every row),
K7 and K8 (on every position) are also held against the torch forms of
their designs (K4's rows must hold records in order without overlap,
K7's offsets must not decrease), and K1 on every call of phases A, D
and G against its plain version and the torch form of its design; K9
on phase A's call against its plain version and on every call of phases
A, D and G against the torch form of its design (greedy_parse_walk), and
on phase D's tile-2048 call against the plain version too; K10 on
phase D's three level-3 passes and phase A's level-2 pass against its
plain version, with the (position, candidate) pairs it compares a ns;
K11 and K12 on every call of phase B against their plain versions;
K6's result
adds its time on each corpus quarter's 64 blocks alone (quarter_ms).
Phase H's calls of K1-K4 are held the same way: K1's and K3's in full
against their plain versions, K2's and K4's on their first rows against
the plain versions and in full against the torch forms of their designs
(launches_h in each result).

Prints the card (nvidia-smi name and power limit), MB/s of every phase,
one JSON line of kernel results, and as its last line
``{"ok": true, "device": {...}}``; every line with a measured number
names the card and its power limit.  Exits non-zero, printing no
result, without a CUDA device or when any phase fails.
"""
from __future__ import annotations

import contextlib
import gzip
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

CORPUS_BYTES = 8 << 20
SEED = 42
KERNEL_REPS = 20
STAGE_C_REPS = 10             # timed stage-C runs of each route, phase D
PLAIN_PREFIX = 8              # rows the per-record plain versions run
K6_PICK = (0, 1, 64, 65, 128, 129, 192, 193)   # two blocks of each corpus
                                               # quarter: K6's plain blocks
QUARTERS = ("text", "repeats", "words", "random")   # make_corpus's order
FILL_SOURCE = "deflate_tpu_torch/csrc/fill_block.cuh"   # K4's and K6's fill
CORE_SOURCE = "deflate_tpu_torch/csrc/stagea_core.cuh"  # K2's and K8's decode
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate


def make_corpus(rng, nbytes: int) -> bytes:
    """Mixed synthetic corpus: text-ish, repetitive, words and random
    segments (the codec benchmark's corpus)."""
    segs = []
    per = nbytes // 4
    segs.append(rng.integers(97, 123, per, dtype=np.uint8))           # text
    pat = rng.integers(0, 256, 509, dtype=np.uint8)
    segs.append(np.tile(pat, per // 509 + 1)[:per])                   # repeats
    words = rng.integers(32, 127, (per // 8, 6), dtype=np.uint8)
    segs.append(np.concatenate(
        [np.concatenate([w, np.array([32, 32], np.uint8)]) for w in
         words[:per // 8]])[:per])                                    # words
    segs.append(rng.integers(0, 256, nbytes - 3 * per, dtype=np.uint8))
    return np.concatenate(segs).tobytes()


def deflate_raw(data: bytes, level: int,
                strategy: int = zlib.Z_DEFAULT_STRATEGY) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
    return co.compress(data) + co.flush()


def word_text(rng, nbytes: int, nwords: int = 300) -> bytes:
    """nbytes of text: random picks from nwords words of 2-8 lowercase
    letters, all drawn from rng, one space after each word."""
    words = [bytes(rng.integers(97, 123, n, dtype=np.uint8)) + b" "
             for n in rng.integers(2, 9, nwords)]
    out = bytearray()
    while len(out) < nbytes:
        out += words[int(rng.integers(0, nwords))]
    return bytes(out[:nbytes])


def corrupt_streams():
    """Thirty corrupt zlib-6 streams of a 6,000-byte word text (words
    from default_rng(1)), each with 1-2 bits flipped at positions drawn
    from the same generator: [(flipped bit positions, stream)]."""
    rng = np.random.default_rng(1)
    good = deflate_raw(word_text(rng, 6000), 6)
    out = []
    for _ in range(30):
        flips = tuple(sorted(int(p) for p in rng.integers(
            0, 8 * len(good), int(rng.integers(1, 3)))))
        bad = bytearray(good)
        for p in flips:
            bad[p >> 3] ^= 1 << (p & 7)
        out.append((flips, bytes(bad)))
    return out


def corrupt_block3(stream: bytes, man) -> bytes:
    """A copy of a manifest stream with 8 bytes XOR 0xA5 from 40 bytes
    past block 3's first byte (the reference's mesh fault injection,
    tests/test_mesh.py)."""
    bad = bytearray(stream)
    off = man.blocks[3][0] // 8 + 40
    for i in range(8):
        bad[off + i] ^= 0xA5
    return bytes(bad)


# the corrupt streams of corrupt_streams() that the skeleton walk and K6
# reject, so that they reach the speculative decoder (the other 26 still
# parse as DEFLATE and decode, to other bytes, through the wave path)
SPECULATIVE_FLIPS = ((2342, 15697), (3134, 18823), (3983, 10076), (4447,))


def speculative_cases():
    """The inputs that only the speculative device decoder serves:
    [(name, raw stream, out_size, the bytes it decodes to, or None where
    the decode must raise InflateError)].

    1. one stored block of 50,000 random lowercase bytes (longer than
       32 KiB);
    2. the corrupt streams of SPECULATIVE_FLIPS;
    3. five streams of a 60,000-byte word text (default_rng(5)) with a
       wrong out_size, len + 1 and len - 1: zlib level 1, level 9,
       level 6 Z_FILTERED, level 6 Z_FIXED, and level 6 on 40,000 bytes
       of the text with 20,000 random bytes in the middle."""
    plain = bytes(np.random.default_rng(0).integers(97, 123, 50000,
                                                    dtype=np.uint8))
    cases = [("stored_50000", deflate_raw(plain, 0), len(plain), plain)]
    cases += [(f"corrupt_{'_'.join(map(str, f))}", s, None, None)
              for f, s in corrupt_streams() if f in SPECULATIVE_FLIPS]
    rng = np.random.default_rng(5)
    text = word_text(rng, 60000)
    mixed = text[:20000] + bytes(rng.integers(0, 256, 20000,
                                              dtype=np.uint8)) \
        + text[20000:40000]
    for name, s, d in (
            ("level1", deflate_raw(text, 1), text),
            ("level9", deflate_raw(text, 9), text),
            ("filtered", deflate_raw(text, 6, zlib.Z_FILTERED), text),
            ("fixed", deflate_raw(text, 6, zlib.Z_FIXED), text),
            ("mixed", deflate_raw(mixed, 6), mixed)):
        cases += [(f"{name}_size{k:+d}", s, len(d) + k, d) for k in (1, -1)]
    return cases


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def require(ok: bool, what: str) -> None:
    """A failed phase check (not an assert: those vanish under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


class Capture:
    """Wraps a module's function and keeps the operands of every call,
    and with keep_results its results too."""

    def __init__(self, mod, name: str, keep_results: bool = False):
        self.mod, self.name = mod, name
        self.fn = getattr(mod, name)
        self.calls, self.results = [], []
        self.keep_results = keep_results
        setattr(mod, name, self)

    def __call__(self, *args, **kw):
        self.calls.append(args + tuple(kw.values()))
        out = self.fn(*args, **kw)
        if self.keep_results:
            self.results.append(out)
        return out

    def restore(self):
        setattr(self.mod, self.name, self.fn)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time per call of fn over reps calls (after one warm-up)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(torch, a, b) -> int:
    if isinstance(a, (list, tuple)):
        return max(max_abs_err(torch, x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return max(max_abs_err(torch, a[k], b[k]) for k in a)
    if a.shape != b.shape:
        raise RuntimeError(f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def nbytes(torch, x) -> int:
    """Bytes of every tensor in x (nested lists, tuples, dicts)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(nbytes(torch, y) for y in x)
    if isinstance(x, dict):
        return sum(nbytes(torch, y) for y in x.values())
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2

    import deflate_tpu_torch as D
    from deflate_tpu_torch import _build, native
    from deflate_tpu_torch.models import block_decoder as BD
    from deflate_tpu_torch.models import decoder as DEC
    from deflate_tpu_torch.models import host_inflate as HI
    from deflate_tpu_torch.models import wave_decoder as WD
    from deflate_tpu_torch.models import encoder as E
    from deflate_tpu_torch.ops import block_inflate, lz77, pack, tree, \
        wave, wave_fill, wave_route, wave_stagea
    from deflate_tpu_torch.runtime import manifest as M
    from deflate_tpu_torch.utils import metrics
    from deflate_tpu_torch.utils.bits import wrap32

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(smi.returncode == 0 and smi.stdout.strip() != "",
            f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    def say(msg: str) -> None:
        """A line of measured numbers, with the card they were taken on."""
        print(f"{msg} [{card}]", flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    native.lib()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s [{card}]")

    # kernel -> (module, wrapper); its launches count as kernel.<K>
    kernels = {
        "K1": (tree, "depths_kernel"),
        "K2": (wave_stagea, "decode_mark_kernel"),
        "K3": (wave_route, "route_kernel"),
        "K4": (wave_fill, "fill_matches_kernel"),
        "K5": (wave_fill, "fill_matches_hist_kernel"),
        "K6": (block_inflate, "inflate_blocks_kernel"),
        "K7": (pack, "pack_blocks_kernel"),
        "K8": (wave_stagea, "decode_positions_kernel"),
        "K9": (lz77, "greedy_parse_kernel"),
        "K10": (lz77, "lag_search_kernel"),
        "K11": (wave, "resolve_litval_kernel"),
        "K12": (wave, "merge_match_runs_kernel"),
    }

    def launched_since_reset(k: str) -> int:
        return metrics.snapshot()["counts"].get("kernel." + k, 0)

    def run_phase(keys, fn):
        """fn() with the counters reset just before and the launches of
        `keys` read just after, and their operands captured; returns
        (result, seconds, launches, captures)."""
        caps = {k: Capture(kernels[k][0], kernels[k][1]) for k in keys}
        metrics.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = {k: launched_since_reset(k) for k in keys}
        for c in caps.values():
            c.restore()
        missing = [k for k, n in launched.items() if n == 0]
        require(not missing, f"kernels never launched: {missing}")
        return res, dt, launched, {k: c.calls for k, c in caps.items()}

    data = make_corpus(np.random.default_rng(SEED), CORPUS_BYTES)
    mb = len(data) / 1e6

    # untimed warm-ups at full size: load every kernel and grow torch's
    # caching allocator, so the timed runs measure steady state
    ws, wm = M.compress_with_manifest(data, level=2, device=dev)
    require(M.decode_all(ws, wm, device=dev) == data, "warm-up decode")
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    raw = co.compress(data) + co.flush()
    require(D.decompress(raw, len(data), device=dev, force_device=True)
            == data, "warm-up foreign decode")
    hs, hm = M.compress_with_manifest(data, level=2, hints=False, device=dev)
    require(M.decode_all(hs, hm, device=dev) == data, "warm-up hintless")

    launches, calls = {}, {}

    # ---- phase A: encode, then hinted device decode (K1-K4, K9, K10) ---
    def phase_a():
        s, m = M.compress_with_manifest(data, level=2, device=dev)
        torch.cuda.synchronize()
        t_enc = time.perf_counter()
        return s, m, M.decode_all(s, m, device=dev), t_enc

    t_start = time.perf_counter()
    (stream, man, out, t_enc), _, la, ca = run_phase(
        ["K1", "K2", "K3", "K4", "K9", "K10"], phase_a)
    t_dec = time.perf_counter() - t_enc
    t_enc -= t_start
    launches.update(la)
    calls.update(ca)
    require(out == data, "decoded output differs from the corpus")
    require(zlib.decompress(stream, -15) == data, "zlib rejects the stream")
    offs = [b[0] for b in man.blocks]
    sizes = [b[2] for b in man.blocks]
    _, produced, err = WD.inflate_wave_device(stream, offs, sizes,
                                              man.hint_array(), device=dev)
    fallback = int(np.count_nonzero(err | (produced != np.asarray(sizes))))
    require(fallback == 0, f"{fallback} blocks took the host fallback")
    say(f"A encode: {len(data)} bytes, {len(man.blocks)} blocks -> "
        f"{len(stream)} bytes (ratio {len(stream) / len(data):.4f}) in "
        f"{t_enc:.3f} s = {mb / t_enc:.2f} MB/s")
    say(f"A device decode: {len(data)} bytes in {t_dec:.3f} s = "
        f"{mb / t_dec:.2f} MB/s")

    # ---- phase B: foreign stream, skeleton walk + wave decode (K2, K3,
    # K5, K11, K12)
    plan = WD.skeleton_plan(raw)
    flags = np.asarray(plan["flags"])       # K5's rows, in order

    def flag_counts(f) -> str:
        return (f"{int(((f & 4) > 0).sum())} history, "
                f"{int(((f & 1) > 0).sum())} stored, "
                f"{int(((f & 2) > 0).sum())} ending at EOB")
    require(((flags & 4) > 0).any() and ((flags & 1) > 0).any(),
            "the foreign plan lacks history or stored virtual blocks")
    st = {}
    out, t_b, lb, cb = run_phase(
        ["K2", "K3", "K5", "K11", "K12"],
        lambda: D.decompress(raw, len(data), device=dev, force_device=True,
                             stats=st))
    launches.update({k: lb[k] for k in ("K5", "K11", "K12")})
    calls.update({k: cb[k] for k in ("K5", "K11", "K12")})
    require(out == data, "foreign decode differs from the corpus")
    require(st["device_path"] == "wave", f"foreign path {st}")
    st_host = {}
    t0 = time.perf_counter()
    out = D.decompress(raw, len(data), device=dev, stats=st_host)
    t_host = time.perf_counter() - t0
    require(out == data and st_host["redirected"] == "device_to_host_default"
            and st_host["device_path"] == "native_host",
            f"redirected decode {st_host}")
    say(f"B foreign zlib-6 stream: {len(raw)} bytes (ratio "
        f"{len(raw) / len(data):.4f}), {len(flags)} virtual blocks "
        f"({flag_counts(flags)}); K2 {lb['K2']}, "
        f"K3 {lb['K3']}, K5 {lb['K5']}, K11 {lb['K11']}, K12 {lb['K12']} "
        f"launches")
    say(f"B device decode (force_device): {t_b:.3f} s = {mb / t_b:.2f} "
        f"MB/s; redirected host decode: {t_host:.3f} s = "
        f"{mb / t_host:.2f} MB/s")

    # ---- the native header parse against the Python walk ---------------
    def header_parse_ms(fn, stream, offsets) -> tuple[dict, float]:
        fn(stream, offsets)                   # warm
        t0 = time.perf_counter()
        out = fn(stream, offsets)
        return out, (time.perf_counter() - t0) * 1e3

    for label, hs_, ho in (("A", stream, offs),
                           ("B", raw, plan["parent_bit"])):
        nat, t_nat = header_parse_ms(wave.parse_headers_host, hs_, ho)
        py, t_py = header_parse_ms(wave._parse_headers_host_py, hs_, ho)
        require(sorted(nat) == sorted(py)
                and all(np.array_equal(nat[k], py[k]) for k in py),
                f"phase {label}: the native header parse differs from "
                f"the Python walk")
        say(f"{label} header parse of {len(ho)} blocks: native walk "
            f"{t_nat:.2f} ms, Python walk {t_py:.2f} ms; equal on every "
            f"key")

    # ---- phase C: hintless manifest, every block through K6 ------------
    def phase_c():
        s, m = M.compress_with_manifest(data, level=2, hints=False,
                                        device=dev)
        torch.cuda.synchronize()
        t_enc = time.perf_counter()
        return s, m, M.decode_all(s, m, device=dev), t_enc

    (hstream, hman, out, t_c0), t_c, lc, cc = run_phase(["K6"], phase_c)
    t_c = time.perf_counter() - t_c0
    launches.update(lc)
    calls.update(cc)
    require(hman.hints is None and out == data, "hintless decode differs")
    require(BD.inflate_manifest(hstream, hman.blocks, device=dev) == data,
            "a block left K6 for the host decoder")
    k6_blocks = sum(int(c[1].shape[0]) for c in calls["K6"])
    require(k6_blocks == len(hman.blocks) == 256,
            f"K6 decoded {k6_blocks} of {len(hman.blocks)} blocks")
    say(f"C hintless device decode: {len(hman.blocks)} blocks in "
        f"{lc['K6']} K6 launches, {t_c:.3f} s = {mb / t_c:.2f} MB/s")

    # ---- phase D: level 3, then stage C alone, merge against K7's route -
    M.compress_with_manifest(data, level=3, device=dev)     # warm-up
    (s3, m3), t_d, ld_merge, cd_merge = run_phase(
        ["K1", "K9", "K10"],
        lambda: M.compress_with_manifest(data, level=3, device=dev))
    k1_d = cd_merge["K1"]
    require(zlib.decompress(s3, -15) == data, "zlib rejects the L3 stream")
    blocks3, blens3 = M.split_blocks(data)
    n3 = len(blens3)
    tb3 = torch.from_numpy(blocks3).to(dev)
    tn3 = torch.from_numpy(blens3).to(dev)
    plans3 = E.batch_plan(tb3, tn3, 3)
    choice3, pad3, _, _ = E.choose_blocks(
        plans3["fixed_bits"], plans3["dyn_bits"], tn3,
        torch.ones(n3, dtype=torch.bool, device=dev), 3)
    args3 = (tb3, tn3, plans3, choice3, pad3,
             torch.arange(n3, device=dev) == n3 - 1)
    emit_routes = {"merge": lambda: E.emit_block(*args3),
                   "K7": lambda: E.emit_block_packed(*args3)}
    require(torch.equal(emit_routes["K7"](), emit_routes["merge"]()),
            "warm-up stage C of the two routes")
    w_merge, _, _, _ = run_phase([], emit_routes["merge"])
    w_k7, _, ld, cd = run_phase(["K3", "K7"], emit_routes["K7"])
    launches["K7"] = ld["K7"]
    calls["K7"] = cd["K7"]
    require(torch.equal(w_k7, w_merge),
            "level-3 stage C words of the two routes differ")
    stage_c_ms = {k: [] for k in emit_routes}
    for r in range(STAGE_C_REPS):           # merge, K7, K7, merge, ...
        for k in (emit_routes if r % 2 == 0 else list(emit_routes)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            emit_routes[k]()
            torch.cuda.synchronize()
            stage_c_ms[k].append((time.perf_counter() - t0) * 1e3)
    stage_c_ms = {k: float(np.median(v)) for k, v in stage_c_ms.items()}
    say(f"D level-3 encode: {len(data)} bytes -> {len(s3)} bytes (ratio "
        f"{len(s3) / len(data):.4f}) in {t_d:.3f} s = {mb / t_d:.2f} MB/s "
        f"(K1 {ld_merge['K1']}, K9 {ld_merge['K9']}, K10 "
        f"{ld_merge['K10']}); stage C alone on its {n3} blocks, median of "
        f"{STAGE_C_REPS}: emit_block {stage_c_ms['merge']:.3f} ms, "
        f"emit_block_packed {stage_c_ms['K7']:.3f} ms (K3 {ld['K3']}, K7 "
        f"{ld['K7']} launches); words identical")

    # ---- phase E: D's stream through the split stage A (K8) ------------
    @contextlib.contextmanager
    def split_stage_a():
        prev = os.environ.get("DT_STAGEAB_PALLAS")
        os.environ["DT_STAGEAB_PALLAS"] = "0"
        try:
            yield
        finally:
            if prev is None:
                del os.environ["DT_STAGEAB_PALLAS"]
            else:
                os.environ["DT_STAGEAB_PALLAS"] = prev

    with split_stage_a():
        require(M.decode_all(s3, m3, device=dev) == data,
                "warm-up split decode")
        out, t_e, le, ce = run_phase(
            ["K3", "K4", "K8"], lambda: M.decode_all(s3, m3, device=dev))
        k2_in_e = launched_since_reset("K2")
        _, produced, err = WD.inflate_wave_device(
            s3, [b[0] for b in m3.blocks], [b[2] for b in m3.blocks],
            m3.hint_array(), device=dev)
    launches["K8"] = le["K8"]
    calls["K8"] = ce["K8"]
    require(out == data, "split decode differs from the corpus")
    require(k2_in_e == 0, f"K2 launched {k2_in_e} times on the split route")
    fallback = int(np.count_nonzero(
        err | (produced != np.asarray([b[2] for b in m3.blocks]))))
    require(fallback == 0, f"{fallback} L3 blocks took the host fallback")
    say(f"E split stage-A decode (DT_STAGEAB_PALLAS=0): {len(data)} bytes "
        f"in {t_e:.3f} s = {mb / t_e:.2f} MB/s; K8 {le['K8']}, K3 "
        f"{le['K3']}, K4 {le['K4']}, K2 {k2_in_e} launches, 0 blocks on "
        f"the host")

    # ---- phase F: the speculative decoder (torch array code, no kernel) -
    # the inputs that neither wave path nor K6 serves, through
    # decompress(force_device=True); then phase A's 8 MiB level-2 stream
    # through the decoder itself (256 blocks, max_blocks 512)
    def phase_f():
        host = Capture(HI, "inflate_raw")
        dec = Capture(DEC, "decode_stream", keep_results=True)
        try:
            for name, sraw, size, want in speculative_cases():
                n_host, n_dec = len(host.calls), len(dec.calls)
                st = {}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    got = D.decompress(sraw, size, device=dev,
                                       force_device=True, stats=st)
                except D.InflateError:
                    got = None
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                flagged = [bool(r[3]) for r in dec.results[n_dec:]]
                hosted = len(host.calls) - n_host
                if want is None:
                    require(got is None and flagged == [True, True]
                            and hosted == 1,
                            f"F {name}: {flagged}, {hosted} host calls")
                    say(f"F {name}: {len(sraw)} bytes, InflateError "
                        f"after both configurations flagged it, in "
                        f"{dt:.3f} s")
                else:
                    require(got == want and hosted == 0 and flagged
                            and not flagged[-1]
                            and st["device_path"] == "speculative",
                            f"F {name}: {st}, {flagged}, {hosted} host "
                            f"calls")
                    say(f"F {name}: {len(want)} bytes through "
                        f"'speculative' (configurations flagged "
                        f"{flagged}) in {dt:.3f} s = "
                        f"{len(want) / 1e6 / dt:.2f} MB/s")
            n_dec = len(dec.calls)
            require(DEC.inflate_device(stream, len(data), device=dev)
                    == data, "F: the level-2 stream differs")   # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = DEC.inflate_device(stream, len(data), device=dev)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            cfg = [c[2:] for c in dec.calls[n_dec:]]
            require(out == data and len(host.calls) == 4
                    and cfg == [(DEC.IS.SPAN, 32768, 512)] * 2,
                    f"F level-2 stream: configurations {cfg}, "
                    f"{len(host.calls)} host calls")
            say(f"F level-2 stream through decoder.inflate_device: "
                f"{len(man.blocks)} blocks, max_blocks 512, {len(data)} "
                f"bytes in {dt:.3f} s = {mb / dt:.2f} MB/s")
        finally:
            host.restore()
            dec.restore()

    run_phase([], phase_f)

    # ---- phase G: the public encode entry points (K1, K9) -------------
    # compress in segments of 64 blocks, stitched on the host, must give
    # phase A's one-batch stream; stats plans every block a second time
    require(D.compress(data, 2, device=dev) == stream, "warm-up compress")
    g_stream, t_g, lg, cg = run_phase(
        ["K1", "K9"], lambda: D.compress(data, 2, device=dev))
    require(g_stream == stream, "compress differs from phase A's stream")
    st_g = {}
    _, _, lg_stats, cg_stats = run_phase(
        ["K1", "K9"], lambda: D.compress(data, 2, stats=st_g, device=dev))
    # the report's histogram against the BTYPE bits of phase A's stream
    # at its manifest's block offsets
    btypes = {"stored": 0, "fixed": 0, "dynamic": 0}
    for bit_off, _, _ in man.blocks:
        bt = sum(((stream[(bit_off + 1 + i) >> 3] >> ((bit_off + 1 + i) & 7))
                  & 1) << i for i in range(2))
        btypes[("stored", "fixed", "dynamic")[bt]] += 1
    require(st_g["block_types"] == btypes
            and st_g["backend"] == "device"
            and st_g["bytes_out"] == len(stream),
            f"G stats {st_g}, stream's block types {btypes}")
    quarters = [data[i * len(data) // 4:(i + 1) * len(data) // 4]
                for i in range(4)]
    want_q = [D.compress(q, 2, device=dev) for q in quarters]
    many, t_many, lg_many, cg_many = run_phase(
        ["K1", "K9"], lambda: D.compress_many(quarters, 2, device=dev))
    require(many == want_q, "compress_many differs from compress per quarter")
    z = D.compress_zlib(data, 2, device=dev)
    g = D.compress_gzip(data, 2, device=dev)
    require(zlib.decompress(z) == data and gzip.decompress(g) == data,
            "python zlib or gzip rejects the container")
    half = len(data) // 2
    two = gzip.compress(data[:half], 6) + gzip.compress(data[half:], 1)
    require(D.decompress_gzip(two) == data, "two-member gzip decode")
    require(D.decompress_gzip(g) == data, "own gzip decode")
    prefix = data[:1 << 20]
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.bin"), os.path.join(tmp, "out.z")
        with open(src, "wb") as f:
            f.write(data)
        _, t_file, lg_file, cg_file = run_phase(
            ["K1", "K9"], lambda: D.compress_file(src, dst, 2, device=dev))
        with open(dst, "rb") as f:
            require(f.read() == stream, "compress_file differs from compress")
        with open(src, "wb") as f:
            f.write(D.compress(prefix, 2, device=dev))
        t0 = time.perf_counter()
        D.decompress_file(src, dst)
        t_dfile = time.perf_counter() - t0
        with open(dst, "rb") as f:
            require(f.read() == prefix, "decompress_file of the prefix")
    ranges = [(0, 100), (32760, 32800), (len(data) - 5000, len(data) + 10)]
    for a, b in ranges:
        require(M.decode_range(stream, man, a, b, device=dev) == data[a:b],
                f"decode_range({a}, {b})")
    small = data[3 << 20:(3 << 20) + 10000]
    for backend in ("native", "auto"):
        st_n = {}
        out = D.compress(small, 2, backend, stats=st_n, device=dev)
        require(zlib.decompress(out, -15) == small
                and st_n["backend"] == "native", f"G backend {backend}")
    launches_g = {"compress": lg["K1"], "stats": lg_stats["K1"],
                  "compress_many": lg_many["K1"],
                  "compress_file": lg_file["K1"]}
    k1_g = [c for cc in (cg, cg_stats, cg_many, cg_file) for c in cc["K1"]]
    launches_g9 = {"compress": lg["K9"], "stats": lg_stats["K9"],
                   "compress_many": lg_many["K9"],
                   "compress_file": lg_file["K9"]}
    k9_g = [c for cc in (cg, cg_stats, cg_many, cg_file) for c in cc["K9"]]
    say(f"G compress: {len(data)} bytes -> {len(g_stream)} bytes, "
        f"identical to phase A's stream, in {t_g:.3f} s = "
        f"{mb / t_g:.2f} MB/s; stats {st_g['block_types']}")
    say(f"G compress_many of 4 quarters: {t_many:.3f} s = "
        f"{mb / t_many:.2f} MB/s; compress_file (chunk_blocks 256): "
        f"{t_file:.3f} s = {mb / t_file:.2f} MB/s; K1 launches "
        f"{launches_g}, K9 launches {launches_g9}")
    say(f"G containers round-trip through python zlib and gzip; "
        f"two-member gzip decoded; decompress_file of a "
        f"{len(prefix)}-byte prefix in {t_dfile:.3f} s (host); "
        f"decode_range on {ranges}; native and auto backends on "
        f"{len(small)} bytes")

    # ---- phase H: data parallelism, a world of one over NCCL -----------
    import dataclasses

    import torch.distributed as dist

    from deflate_tpu_torch import entry as EN
    from deflate_tpu_torch.parallel import mesh as PM

    mesh = PM.make_mesh(device=dev)
    require(mesh.size() == 1 and dist.get_backend() == "nccl",
            f"phase H mesh {mesh}, backend {dist.get_backend()}")
    try:
        require(PM.compress_mesh(data, 2, mesh) == stream,
                "warm-up compress_mesh")
        h_stream, t_hc, lh, ch = run_phase(
            ["K1"], lambda: PM.compress_mesh(data, 2, mesh))
        require(h_stream == stream, "compress_mesh differs from phase A's "
                "stream")
        require(PM.decompress_mesh(stream, man, mesh) == data,
                "warm-up decompress_mesh")
        wave_hits = Capture(PM, "decompress_mesh_wave")
        try:
            out, t_hw, lhw, chw = run_phase(
                ["K2", "K3", "K4"],
                lambda: PM.decompress_mesh(stream, man, mesh))
        finally:
            wave_hits.restore()
        require(out == data and len(wave_hits.calls) == 1,
                f"mesh wave decode differs ({len(wave_hits.calls)} wave "
                f"route calls)")
        lh.update(lhw)
        ch.update(chw)
        sman = dataclasses.replace(hman, blocks=hman.blocks[:64])
        prefix_h = data[:sum(b[2] for b in sman.blocks)]
        out, t_hs, _, _ = run_phase(
            [], lambda: PM.decompress_mesh(hstream, sman, mesh))
        require(out == prefix_h, "mesh scan decode differs from the prefix")
        try:
            PM.decompress_mesh(corrupt_block3(stream, man), man, mesh)
            corrupt_raised = False
        except ValueError:
            corrupt_raised = True
        require(corrupt_raised, "a corrupted stream decoded on the mesh")
        t0 = time.perf_counter()
        rec = EN.dryrun_multichip(1)
        t_dry = time.perf_counter() - t0
        require(rec["n_devices"] == 1 and rec["card"] == card,
                f"dryrun record {rec}")
    finally:
        dist.destroy_process_group()
    say(f"H mesh of 1 rank (NCCL): compress_mesh {t_hc:.3f} s = "
        f"{mb / t_hc:.2f} MB/s, identical to phase A's stream (K1 "
        f"{lh['K1']}); decompress_mesh wave route {t_hw:.3f} s = "
        f"{mb / t_hw:.2f} MB/s (K2 {lh['K2']}, K3 {lh['K3']}, K4 "
        f"{lh['K4']} launches, W64 {chw['K2'][0][3]} for all "
        f"{len(man.blocks)} rows)")
    say(f"H decompress_mesh scan route, first {len(sman.blocks)} blocks "
        f"of phase C: {t_hs:.3f} s = {len(prefix_h) / 1e6 / t_hs:.2f} MB/s "
        f"({t_hs * 1e3 / len(sman.blocks):.1f} ms a block); corrupted "
        f"stream raised ValueError; dryrun_multichip(1) in {t_dry:.3f} s, "
        f"mesh speedup {rec['mesh_speedup_vs_single_program']:.3f} "
        f"(passed: {rec['passed']})")

    # ---- each kernel against its plain version, phase operands ---------
    def timed(fn, reps: int = KERNEL_REPS) -> float:
        return cuda_ms(torch, fn, reps)

    def k3_kernel_only_ms(c) -> float:
        """dt_route alone (no allocation, no checks) into preallocated
        outputs: the device side of the wrapper's time."""
        pays, delta, rounds, left = c
        B, L = delta.shape
        outs = [torch.empty_like(delta) for _ in range(len(pays) + 1)]
        last = torch.empty((B, -(-L // wave_route.TILE)), dtype=torch.int32,
                           device=dev)
        return timed(lambda: wave_route.launch(
            pays, delta, [o.data_ptr() for o in outs[:-1]],
            outs[-1].data_ptr(), last.data_ptr(), rounds, left))

    def k3_library_ms(c) -> float:
        """One torch scatter_ moving both payloads to the same slots."""
        pays, delta, _, left = c
        B, L = delta.shape
        lane = torch.arange(L, device=dev)[None, :]
        dst = lane - delta if left else lane + delta
        ok = (delta >= 0) & (dst >= 0) & (dst < L)
        idx = torch.where(ok, dst, L).to(torch.int64)
        src = torch.stack(list(pays))
        idx = idx[None].expand_as(src).contiguous()
        dest = torch.zeros((src.shape[0], B, L + 1), dtype=src.dtype,
                           device=dev)
        return timed(lambda: dest.scatter_(2, idx, src))

    def fill_bytes(c) -> int:
        # literal rows in, 8 B per record this run holds, rows out
        lit, nm = c[0], c[2]
        return 2 * nbytes(torch, lit) + 8 * int(nm.clamp(min=0).sum()) \
            + nbytes(torch, c[2:])

    def hist_bytes(c) -> int:
        # only each row's sizes[b] bytes are read and written (padding
        # rows have none), 8 B per record, the nmatch and sizes words
        nm, sizes = c[2], c[3]
        return 2 * int(sizes.clamp(0, wave_fill.ND).sum()) \
            + 8 * int(nm.clamp(min=0).sum()) + nbytes(torch, c[2:])

    results = []

    def check(name, key, src, rep, kfn, pfn, kcalls, pcalls=None,
              bound_bytes=None, library=None, cmp=None):
        """max |kernel - plain| over pcalls (default kcalls); kernel time
        summed over kcalls, plain time over pcalls."""
        pcalls = pcalls or kcalls
        cmp = cmp or (lambda got, want, c: max_abs_err(torch, got, want))
        err = 0
        for c in pcalls:
            got, want = kfn(*c), pfn(*c)
            torch.cuda.synchronize()
            err = max(err, cmp(got, want, c))
        ms = sum(timed(lambda c=c: kfn(*c)) for c in kcalls)
        pms = sum(timed(lambda c=c: pfn(*c), 1) for c in pcalls)
        if bound_bytes is None:
            bound_bytes = sum(nbytes(torch, c) + nbytes(torch, kfn(*c))
                              for c in kcalls)
        results.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[key], "max_abs_err": err, "ms": ms,
            "plain_ms": pms,
            "bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": (sum(library(c) for c in kcalls)
                           if library else None),
            "card": card})

    def head(c, n=PLAIN_PREFIX):
        """A call's operands cut to their first n rows."""
        return tuple(x[:n] if isinstance(x, torch.Tensor) else x for x in c)

    # phase H's calls: K2's and K4's first rows against the plain
    # versions, every row against the torch forms of their designs; K3's
    # in full against the plain version (K1's join K1's lists below)
    h_err = {
        "K2": max(max(max_abs_err(torch, wave_stagea.decode_mark_kernel(
            *head(c)), wave_stagea.decode_mark_plain(*head(c))),
            max_abs_err(torch, wave_stagea.decode_mark_kernel(*c),
                        wave_stagea.decode_mark_lut(*c))) for c in ch["K2"]),
        "K3": max(max_abs_err(torch, wave_route.route_kernel(*c),
                              wave_route.route_plain(*c)) for c in ch["K3"]),
        "K4": max(max(max_abs_err(torch, wave_fill.fill_matches_kernel(
            *head(c)), wave_fill.fill_matches_plain(*head(c))),
            max_abs_err(torch, wave_fill.fill_matches_kernel(*c),
                        wave_fill.fill_matches_jump(*c))) for c in ch["K4"]),
    }
    torch.cuda.synchronize()

    # every K1 call of phases A, D, G and H against the plain version and
    # the torch form of the design, depths_jump
    k1_all = calls["K1"] + k1_d + k1_g + ch["K1"]
    k1_more = max(max(max_abs_err(torch, tree.depths_kernel(*c),
                                  tree.depths_plain(*c))
                      for c in k1_d + k1_g + ch["K1"]),
                  max(max_abs_err(torch, tree.depths_kernel(*c),
                                  tree.depths_jump(*c)) for c in k1_all))
    k1_steps = sum(int((c[1].to(torch.int64) - 1).clamp(min=0).sum())
                   for c in calls["K1"])

    def k1_kernel_only_ms(c) -> float:
        """dt_tree_depths alone (no allocation, no checks) into a
        preallocated output."""
        out = torch.empty((c[0].shape[0], tree.NW), dtype=torch.int32,
                          device=dev)
        return timed(lambda: tree.depths_launch(*c, out))

    check(f"K1 tree (litlen, dist, CL tree batches of phase A, "
          f"{k1_steps} merge steps; all {len(k1_all)} calls of phases A, "
          f"D, G and H also compared with depths_plain and depths_jump; "
          f"kernel_only_ms: dt_tree_depths alone into a preallocated "
          f"output)", "K1",
          "deflate_tpu_torch/csrc/tree.cu",
          "deflate_tpu/ops/pallas_tree.py:40", tree.depths_kernel,
          tree.depths_plain, calls["K1"],
          cmp=lambda got, want, c: max(max_abs_err(torch, got, want),
                                       k1_more))
    results[-1]["kernel_only_ms"] = sum(k1_kernel_only_ms(c)
                                        for c in calls["K1"])
    results[-1]["merge_steps"] = k1_steps
    results[-1]["launches_d"] = ld_merge["K1"]
    results[-1]["launches_g"] = launches_g
    results[-1]["launches_h"] = lh["K1"]
    log(f"K1: wrapper {results[-1]['ms']:.4f} ms, dt_tree_depths alone "
        f"{results[-1]['kernel_only_ms']:.4f} ms over {k1_steps} merge "
        f"steps; {len(k1_all)} calls of phases A, D and G compared "
        f"[{card}]")

    def k2_kernel_only_ms(c) -> float:
        """dt_decode_mark alone (its table build and decode, no
        allocation, no checks) into preallocated outputs."""
        nw, hs, mds, W64, stop, maxl, maxd = c
        nw, hs, mds = (x.to(torch.int32).contiguous() for x in (nw, hs, mds))
        if stop is not None:
            stop = stop.to(torch.int32).contiguous()
        out = [torch.empty_like(x) for x in wave_stagea.decode_mark_kernel(
            *c)]
        tables = torch.empty((nw.shape[0], wave_stagea.TABLE_WORDS),
                             dtype=torch.int32, device=dev)
        return timed(lambda: wave_stagea.mark_launch(
            nw, hs, mds, stop, *out, tables, W64, maxl, maxd))

    # every K2 call of phases A and B (B's with their stop bits) against
    # the torch form of its design, decode_mark_lut
    k2_lut = max(max_abs_err(torch, wave_stagea.decode_mark_kernel(*c),
                             wave_stagea.decode_mark_lut(*c))
                 for c in calls["K2"] + cb["K2"])
    k2_steps = sum(int(wave_stagea.decode_mark_kernel(*c)[2][:, 5].sum())
                   for c in calls["K2"])
    check(f"K2 decode_mark ({len(calls['K2'])} buckets of phase A, "
          f"{k2_steps} chain steps; all {len(calls['K2']) + len(cb['K2'])} "
          f"calls of phases A and B also compared with decode_mark_lut; "
          f"phase H's {len(ch['K2'])} calls with both, the plain version "
          f"on their first {PLAIN_PREFIX} rows; "
          f"kernel_only_ms: dt_decode_mark alone into preallocated "
          f"outputs)", "K2",
          "deflate_tpu_torch/csrc/wave_stagea.cu",
          "deflate_tpu/ops/wave_stagea.py:73",
          wave_stagea.decode_mark_kernel, wave_stagea.decode_mark_plain,
          calls["K2"],
          cmp=lambda got, want, c: max(max_abs_err(torch, got, want),
                                       k2_lut, h_err["K2"]))
    results[-1]["launches_h"] = lh["K2"]
    results[-1]["core_source"] = CORE_SOURCE
    results[-1]["kernel_only_ms"] = sum(k2_kernel_only_ms(c)
                                        for c in calls["K2"])
    results[-1]["chain_steps"] = k2_steps
    results[-1]["ns_per_step"] = results[-1]["kernel_only_ms"] * 1e6 \
        / k2_steps
    log(f"K2: wrapper {results[-1]['ms']:.4f} ms, dt_decode_mark alone "
        f"{results[-1]['kernel_only_ms']:.4f} ms, "
        f"{results[-1]['ns_per_step']:.4f} ns a chain step [{card}]")
    check(f"K3 route ({len(calls['K3'])} calls of phase A, and phase "
          f"H's {len(ch['K3'])} compared; library_ms: "
          "torch scatter_ to the same slots; kernel_only_ms: dt_route "
          "alone into preallocated outputs)", "K3",
          "deflate_tpu_torch/csrc/wave_route.cu",
          "deflate_tpu/ops/wave_route.py:46", wave_route.route_kernel,
          wave_route.route_plain, calls["K3"], library=k3_library_ms,
          cmp=lambda got, want, c: max(max_abs_err(torch, got, want),
                                       h_err["K3"]))
    results[-1]["launches_h"] = lh["K3"]
    results[-1]["kernel_only_ms"] = sum(k3_kernel_only_ms(c)
                                        for c in calls["K3"])
    log(f"K3: wrapper {results[-1]['ms']:.4f} ms, dt_route alone "
        f"{results[-1]['kernel_only_ms']:.4f} ms, scatter_ "
        f"{results[-1]['library_ms']:.4f} ms, bound "
        f"{results[-1]['bound_ms']:.4f} ms [{card}]")

    def records_in_order(c) -> bool:
        """Every row's live records come in order of opos and none
        overlaps the next: the contract under which K4 equals the ordered
        copy (csrc/fill_block.cuh)."""
        _, recs, nm = c
        r0 = recs.reshape(recs.shape[0], -1, 2)[..., 0].to(torch.int64)
        p = r0 & 0x7FFF
        fld = (r0 >> 16) & 0x7FFF
        end = p + torch.where((r0 >> 15) & 1 > 0, 3 + (fld & 1), fld + 3)
        nxt = torch.arange(1, r0.shape[1], device=dev)[None, :]
        live = nxt < nm.to(torch.int64)[:, None]
        return bool(((end[:, :-1] <= p[:, 1:]) | ~live).all())

    k4 = calls["K4"]
    for c in k4 + ch["K4"]:
        require(records_in_order(c), "K4's records overlap or are unordered")
    # every row of every bucket against the torch form of the design
    k4_full = max(max_abs_err(torch, wave_fill.fill_matches_kernel(*c),
                              wave_fill.fill_matches_jump(*c)) for c in k4)
    check(f"K4 fill_matches ({len(k4)} buckets of phase A, "
          f"{[int(c[2].clamp(min=0).sum()) for c in k4]} records; compared "
          f"with and plain_ms on the first {PLAIN_PREFIX} blocks of each, "
          f"all rows with fill_matches_jump; phase H's {len(ch['K4'])} "
          f"calls the same way)", "K4",
          "deflate_tpu_torch/csrc/wave_fill.cu",
          "deflate_tpu/ops/wave_fill.py:336",
          wave_fill.fill_matches_kernel, wave_fill.fill_matches_plain,
          k4, [head(c) for c in k4],
          cmp=lambda got, want, c: max(max_abs_err(torch, got, want),
                                       k4_full, h_err["K4"]),
          bound_bytes=sum(fill_bytes(c) for c in k4))
    results[-1]["launches_h"] = lh["K4"]
    results[-1]["fill_source"] = FILL_SOURCE
    results[-1]["per_launch_ms"] = [timed(lambda c=c: wave_fill
                                          .fill_matches_kernel(*c))
                                    for c in k4]
    k5 = calls["K5"]
    require(len(k5) == 1, f"K5 ran {len(k5)} times in phase B")
    lit5, _, nm5, sizes5 = k5[0]

    def k5_cmp(got, want, c):
        # the prefix against the plain version, every row in full against
        # the torch form of the kernel's design (fill_matches_hist_jump),
        # and every row without records (the stored rows) against its
        # literal row, which is what the plain version returns for such a
        # row
        full = wave_fill.fill_matches_hist_kernel(*k5[0])
        jump = wave_fill.fill_matches_hist_jump(*k5[0])
        byte = torch.arange(wave_fill.ND, device=dev)[None, :]
        keep = (nm5 == 0)[:, None] & (byte < sizes5[:, None])

        def as_bytes(x):
            return x.contiguous().view(torch.uint8).reshape(x.shape[0], -1)

        return max(max_abs_err(torch, got, want),
                   max_abs_err(torch, as_bytes(full), as_bytes(jump)),
                   max_abs_err(torch, torch.where(keep, as_bytes(full), 0),
                               torch.where(keep, as_bytes(lit5), 0)))

    bare = (nm5 == 0).cpu().numpy()[:len(flags)]
    check(f"K5 fill_matches_hist (phase B, {lit5.shape[0]} rows, "
          f"{int(nm5.sum())} records; compared with and plain_ms on the "
          f"first {PLAIN_PREFIX} rows ({flag_counts(flags[:PLAIN_PREFIX])}),"
          f" all rows with fill_matches_hist_jump, and its "
          f"{int(bare.sum())} rows without records "
          f"({flag_counts(flags[bare])}) with their literal rows)", "K5",
          "deflate_tpu_torch/csrc/wave_fill_hist.cu",
          "deflate_tpu/ops/wave_fill.py:384",
          wave_fill.fill_matches_hist_kernel,
          wave_fill.fill_matches_hist_plain, k5,
          [head(c) for c in k5], cmp=k5_cmp,
          bound_bytes=sum(hist_bytes(c) for c in k5))

    def k6_pick(kcalls):
        """The blocks of K6_PICK (indices over all calls in order), as
        one call per call that holds any of them."""
        picked, base = [], 0
        for words, start_w, bit0, avail, statics in kcalls:
            B = start_w.shape[0]
            ix = [i - base for i in K6_PICK if base <= i < base + B]
            if ix:
                ix = torch.tensor(ix, device=start_w.device)
                picked.append((words, start_w[ix], bit0[ix], avail[ix],
                               statics))
            base += B
        return picked

    def btype(bit: int) -> int:
        return (int.from_bytes(hstream[bit >> 3:(bit >> 3) + 2], "little")
                >> ((bit & 7) + 1)) & 3

    picked_types = [btype(hman.blocks[i][0]) for i in K6_PICK]
    require(0 in picked_types and 2 in picked_types,
            f"K6's compared blocks have block types {picked_types}")

    def k6_cmp(got, want, c):
        # status (produced, err, end bit) and rows; where err is set only
        # err is part of the contract
        (go, gs), (wo, ws) = got, want
        ok = (ws[:, 1] == 0)[:, None]
        return max(max_abs_err(torch, gs[:, 1], ws[:, 1]),
                   max_abs_err(torch, torch.where(ok, gs, 0),
                               torch.where(ok, ws, 0)),
                   max_abs_err(torch, torch.where(ok, go, 0),
                               torch.where(ok, wo, 0)))

    def k6_bytes(c) -> int:
        # the blocks' compressed bits in, statics and per-block words in,
        # each block's produced bytes and its status out
        _, status = block_inflate.inflate_blocks_kernel(*c)
        bits = int((status[:, 2] - c[2]).clamp(min=0).sum())
        return bits // 8 + nbytes(torch, c[1:]) \
            + int(status[:, 0].clamp(min=0).sum()) + nbytes(torch, status)

    k6 = [c[:5] for c in calls["K6"]]       # without the rows it fills
    check(f"K6 inflate_blocks (phase C, {k6_blocks} blocks; compared with "
          f"and plain_ms on blocks {list(K6_PICK)}, of block types "
          f"{picked_types})", "K6",
          "deflate_tpu_torch/csrc/block_inflate.cu",
          "deflate_tpu/ops/pallas_inflate.py:211",
          block_inflate.inflate_blocks_kernel,
          block_inflate.inflate_blocks_plain, k6,
          k6_pick(k6), cmp=k6_cmp,
          bound_bytes=sum(k6_bytes(c) for c in k6))
    require(len(k6) == 1, f"K6 ran {len(k6)} times in phase C")
    words6, start6, bit06, avail6, statics6 = k6[0]

    def k6_quarter_ms(q: int) -> float:
        ix = torch.arange(64 * q, 64 * (q + 1), device=dev)
        return timed(lambda: block_inflate.inflate_blocks_kernel(
            words6, start6[ix], bit06[ix], avail6[ix], statics6))

    results[-1]["fill_source"] = FILL_SOURCE
    results[-1]["quarter_ms"] = {name: k6_quarter_ms(q)
                                 for q, name in enumerate(QUARTERS)}

    def k7_library_all_lanes_ms(c) -> float:
        """One torch scatter_add_ of all 3 x NPK lanes of every row, dead
        lanes sent to one spare column (the earlier yardstick: mostly the
        contention of those lanes on that column)."""
        idx, vals = pack.packet_words(*c)
        vals = wrap32(vals)
        dest = torch.zeros((idx.shape[0], pack.OUTW + 1), dtype=torch.int32,
                           device=dev)
        return timed(lambda: dest.scatter_add_(1, idx, vals))

    def k7_library_ms(c) -> float:
        """One torch index_add_ of only the live packets' nonzero words
        below OUTW into the flat [B * OUTW] output, indices and values
        prepared before the timing; it must give the plain words."""
        idx, vals = pack.packet_words(*c)
        rows = torch.arange(idx.shape[0], device=dev)[:, None]
        keep = (idx < pack.OUTW) & (vals != 0)
        flat = (rows * pack.OUTW + idx)[keep]
        vals = wrap32(vals[keep])
        dest = torch.zeros(idx.shape[0] * pack.OUTW, dtype=torch.int32,
                           device=dev)
        dest.index_add_(0, flat, vals)
        require(torch.equal(dest.view(-1, pack.OUTW),
                            pack.pack_blocks_plain(*c)),
                "K7's index_add_ yardstick differs from the plain words")
        results[-1]["library_words"] = int(flat.numel())
        return timed(lambda: dest.index_add_(0, flat, vals))

    def k7_kernel_only_ms(c) -> float:
        """dt_pack_blocks alone (no allocation, no checks) into a
        preallocated output."""
        out = torch.empty((c[0].shape[0], pack.OUTW), dtype=torch.int32,
                          device=dev)
        return timed(lambda: pack.pack_launch(*c, out))

    k7 = calls["K7"]
    require(len(k7) == 1, f"K7 ran {len(k7)} times in phase D")
    counts7, off7 = k7[0][0], k7[0][1]
    npackets = int(counts7.clamp(0, pack.NPK).sum())
    # K7's contract: offsets >= 0 and not decreasing over [0, count)
    lane7 = torch.arange(pack.NPK, device=dev)[None, :]
    live7 = lane7 < counts7[:, None]
    require(bool(((off7 >= 0) | ~live7).all())
            and bool(((off7[:, 1:] >= off7[:, :-1]) | ~live7[:, 1:]).all()),
            "phase D's packet offsets decrease or are negative")
    # phase D's call against the torch form of the design as well
    k7_tiles = max_abs_err(torch, pack.pack_blocks_kernel(*k7[0]),
                           pack.pack_blocks_tiles(*k7[0]))
    check(f"K7 pack_blocks (phase D, {k7[0][1].shape[0]} blocks, "
          f"{npackets} packets, offsets checked monotone; also compared "
          f"with pack_blocks_tiles; library_ms: torch index_add_ of the "
          f"live packets' nonzero words, library_all_lanes_ms: one "
          f"scatter_add_ of all lanes; kernel_only_ms: dt_pack_blocks "
          f"alone into a preallocated output)", "K7",
          "deflate_tpu_torch/csrc/pack.cu",
          "deflate_tpu/ops/pallas_pack.py:49", pack.pack_blocks_kernel,
          pack.pack_blocks_plain, k7,
          cmp=lambda got, want, c: max(max_abs_err(torch, got, want),
                                       k7_tiles),
          # the live packets' offset and two payload words, the counts,
          # the words out
          bound_bytes=12 * npackets + nbytes(torch, counts7)
          + k7[0][1].shape[0] * pack.OUTW * 4)
    results[-1]["library_ms"] = sum(k7_library_ms(c) for c in k7)
    results[-1]["library_all_lanes_ms"] = sum(k7_library_all_lanes_ms(c)
                                              for c in k7)
    results[-1]["kernel_only_ms"] = sum(k7_kernel_only_ms(c) for c in k7)
    log(f"K7: {results[-1]['ms']:.4f} ms, alone "
        f"{results[-1]['kernel_only_ms']:.4f}, index_add_ "
        f"{results[-1]['library_ms']:.4f} ({results[-1]['library_words']} "
        f"words), all-lanes scatter_add_ "
        f"{results[-1]['library_all_lanes_ms']:.4f} [{card}]")
    k8 = calls["K8"]
    k8_positions = sum(int(c[0].shape[0]) * 64 * c[2] for c in k8)
    # every position of every bucket against the plain version (check's
    # comparison) and the torch form of the design, decode_positions_lut
    k8_lut = max(max_abs_err(torch, wave_stagea.decode_positions_kernel(*c),
                             wave_stagea.decode_positions_lut(*c))
                 for c in k8)
    check(f"K8 decode_positions ({len(k8)} buckets of phase E, W64 "
          f"{[c[2] for c in k8]}, {k8_positions} positions, each compared "
          f"with the plain version and decode_positions_lut)", "K8",
          "deflate_tpu_torch/csrc/wave_stagea.cu",
          "deflate_tpu/ops/wave_stagea.py:53",
          wave_stagea.decode_positions_kernel,
          wave_stagea.decode_positions_plain, k8,
          cmp=lambda got, want, c: max(max_abs_err(torch, got, want),
                                       k8_lut))
    results[-1]["core_source"] = CORE_SOURCE
    results[-1]["positions"] = k8_positions
    results[-1]["ns_per_position"] = results[-1]["ms"] * 1e6 / k8_positions
    results[-1]["per_launch_ms"] = [timed(lambda c=c: wave_stagea
                                          .decode_positions_kernel(*c))
                                    for c in k8]
    log(f"K8: {results[-1]['ms']:.4f} ms over {k8_positions} positions, "
        f"{results[-1]['ns_per_position']:.5f} ns a position, per launch "
        f"{results[-1]['per_launch_ms']} [{card}]")

    k9 = calls["K9"]
    require(len(k9) == 1 and len(cd_merge["K9"]) == 1,
            f"K9 ran {len(k9)} times in phase A, {len(cd_merge['K9'])} in D")
    k9_d = cd_merge["K9"][0]
    # every K9 call of phases A, D and G against the torch form of the
    # design, greedy_parse_walk; phase D's (tile 2048) against the plain
    # version as well
    k9_more = max(max(max_abs_err(torch, lz77.greedy_parse_kernel(*c),
                                  lz77.greedy_parse_walk(*c))
                      for c in k9 + [k9_d] + k9_g),
                  max_abs_err(torch, lz77.greedy_parse_kernel(*k9_d),
                              lz77.greedy_parse_plain(*k9_d)))
    check(f"K9 greedy_parse (phase A, {k9[0][0].shape[0]} blocks, tile "
          f"{k9[0][3]}; all {2 + len(k9_g)} calls of phases A, D and G "
          f"also compared with greedy_parse_walk, phase D's tile-"
          f"{k9_d[3]} call with the plain version; bound: 4 bytes in and "
          f"5 out a position)", "K9",
          "deflate_tpu_torch/csrc/parse.cu",
          "deflate_tpu/ops/lz77.py:292 (lax.scan)",
          lz77.greedy_parse_kernel, lz77.greedy_parse_plain, k9,
          cmp=lambda got, want, c: max(max_abs_err(torch, got, want),
                                       k9_more))
    results[-1]["launches_d"] = ld_merge["K9"]
    results[-1]["launches_g"] = launches_g9
    results[-1]["ms_tile_2048"] = timed(
        lambda: lz77.greedy_parse_kernel(*k9_d))
    results[-1]["plain_ms_tile_2048"] = timed(
        lambda: lz77.greedy_parse_plain(*k9_d), 1)
    log(f"K9: {results[-1]['ms']:.4f} ms at tile {k9[0][3]}, plain "
        f"{results[-1]['plain_ms']:.4f}; tile 2048 "
        f"{results[-1]['ms_tile_2048']:.4f}, plain "
        f"{results[-1]['plain_ms_tile_2048']:.4f} [{card}]")

    k10, k10_d = calls["K10"], cd_merge["K10"]
    require(len(k10) == 1 and len(k10_d) == 1 + len(E.L3_TIERS),
            f"K10 ran {len(k10)} times in phase A, {len(k10_d)} in D")
    k10_a_err = max(max_abs_err(torch, lz77.lag_search_kernel(*c),
                                lz77.lag_search_plain(*c)) for c in k10)

    def pairs(cs) -> int:
        # positions x chain depth: the pairs each pass asks for
        return sum(c[0].numel() * c[3] for c in cs)

    check(f"K10 lag_search (phase D's {len(k10_d)} level-3 passes, "
          f"{k10_d[0][0].shape[0]} blocks, K {k10_d[0][3]}, W "
          f"{k10_d[0][4]}; phase A's level-2 pass also compared with the "
          f"plain version; bound: 13 bytes a position, the byte, the key "
          f"and two int32 results)", "K10",
          "deflate_tpu_torch/csrc/lag_search.cu",
          "none: XLA code, deflate_tpu/ops/lz77.py:94 find_matches",
          lz77.lag_search_kernel, lz77.lag_search_plain, k10_d,
          bound_bytes=sum(13 * c[0].numel() for c in k10_d),
          cmp=lambda got, want, c: max(max_abs_err(torch, got, want),
                                       k10_a_err))
    r10 = results[-1]
    r10["launches"], r10["launches_a"] = ld_merge["K10"], launches["K10"]
    r10["pairs_per_ns"] = pairs(k10_d) / (r10["ms"] * 1e6)
    r10["ms_level2"] = timed(lambda: lz77.lag_search_kernel(*k10[0]))
    r10["plain_ms_level2"] = timed(
        lambda: lz77.lag_search_plain(*k10[0]), 1)
    r10["bound_ms_level2"] = 13 * k10[0][0].numel() / HBM_BYTES_PER_S * 1e3
    r10["pairs_per_ns_level2"] = pairs(k10) / (r10["ms_level2"] * 1e6)
    log(f"K10: {r10['ms']:.4f} ms over phase D's {len(k10_d)} passes "
        f"({r10['pairs_per_ns']:.2f} pairs/ns), plain "
        f"{r10['plain_ms']:.4f}; level 2 {r10['ms_level2']:.4f} "
        f"({r10['pairs_per_ns_level2']:.2f} pairs/ns), plain "
        f"{r10['plain_ms_level2']:.4f} [{card}]")

    # K11 and K12 on every call of phase B (one of each a wave_decode)
    k11, k12 = calls["K11"], calls["K12"]
    require(len(k11) == len(k12) == launches["K11"] == launches["K12"],
            f"K11 ran {len(k11)} times in phase B, K12 {len(k12)}")
    check(f"K11 resolve_litval (phase B's {len(k11)} wave_decode calls, "
          f"{k11[0][0].shape[0]} x {k11[0][0].shape[1]} lanes each; bound: "
          f"two int32 reads and one write a lane)", "K11",
          "deflate_tpu_torch/csrc/wave_glue.cu",
          "none: XLA code, deflate_tpu/ops/wave.py:716 resolve_litval",
          wave.resolve_litval_kernel, wave.resolve_litval_plain, k11)
    check(f"K12 merge_match_runs (phase B's {len(k12)} wave_decode calls, "
          f"{k12[0][0].shape[0]} x {k12[0][0].shape[1]} records each; "
          f"bound: two int32 reads and two writes a record)", "K12",
          "deflate_tpu_torch/csrc/wave_glue.cu",
          "none: XLA code, deflate_tpu/ops/wave.py:744 merge_match_runs",
          wave.merge_match_runs_kernel, wave.merge_match_runs_plain, k12)
    for r in results[-2:]:
        log(f"{r['name'][:3]}: {r['ms']:.4f} ms over {len(k11)} calls, "
            f"plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} "
            f"[{card}]")

    bad = [r["name"] for r in results if r["max_abs_err"] != 0]
    for r in results:
        log(f"{r['name']}: max_abs_err {r['max_abs_err']}, kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms, launches {r['launches']} [{card}]")
    require(not bad, f"kernels disagree with their plain versions: {bad}")

    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
