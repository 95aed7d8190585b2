"""Smoke run of deflate_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from deflate_tpu_torch/csrc/, drives the main
path — level-2 ``compress_with_manifest`` of an 8 MiB mixed corpus (256
blocks of 32 KiB), then ``decode_all`` on the card — and checks that the
output equals the input, that zlib decodes the stream, that no block fell
back to the host decoder, and that every kernel of the path launched.
Then each kernel is held against its plain PyTorch version on the card,
on operands the main path gave it, and both are timed with CUDA events.

Prints the card (nvidia-smi name and power limit), encode and decode
MB/s, one JSON line of kernel results, and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device or when any phase fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import zlib

import numpy as np

CORPUS_BYTES = 8 << 20
SEED = 42
KERNEL_REPS = 20
FILL_PLAIN_BLOCKS = 8


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


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def require(ok: bool, what: str) -> None:
    """A failed phase check (not an assert: those vanish under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


class Capture:
    """Wraps a kernel entry point and keeps the operands of every call."""

    def __init__(self, mod, name: str):
        self.mod, self.name = mod, name
        self.fn = getattr(mod, name)
        self.calls = []
        setattr(mod, name, self)

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        return self.fn(*args, **kw)

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2

    from deflate_tpu_torch import _build
    from deflate_tpu_torch.models import wave_decoder as WD
    from deflate_tpu_torch.ops import tree, wave_fill, wave_route, \
        wave_stagea
    from deflate_tpu_torch.runtime import manifest as M

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(smi.returncode == 0 and smi.stdout.strip() != "",
            f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")

    data = make_corpus(np.random.default_rng(SEED), CORPUS_BYTES)

    # untimed warm-up at full size: loads every kernel and grows torch's
    # caching allocator, so the timed run below measures steady state
    ws, wm = M.compress_with_manifest(data, level=2, device=dev)
    require(M.decode_all(ws, wm, device=dev) == data, "warm-up decode")

    # capture operands the main path hands each kernel
    caps = {
        "tree": Capture(tree, "depths_kernel"),
        "wave_stagea": Capture(wave_stagea, "decode_mark_kernel"),
        "wave_route": Capture(wave_route, "route_kernel"),
        "wave_fill": Capture(wave_fill, "fill_matches_kernel"),
    }
    mods = {"tree": tree, "wave_stagea": wave_stagea,
            "wave_route": wave_route, "wave_fill": wave_fill}

    # ---- main path: encode, then device decode --------------------------
    for m in mods.values():
        m.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream, man = M.compress_with_manifest(data, level=2, device=dev)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = M.decode_all(stream, man, device=dev)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = {k: m.launches for k, m in mods.items()}
    for c in caps.values():
        c.restore()

    require(out == data, "decoded output differs from the corpus")
    require(zlib.decompress(stream, -15) == data, "zlib rejects the stream")
    offs = [b[0] for b in man.blocks]
    sizes = [b[2] for b in man.blocks]
    _, produced, err = WD.inflate_wave_device(stream, offs, sizes,
                                              man.hint_array(), device=dev)
    fallback = int(np.count_nonzero(err | (produced != np.asarray(sizes))))
    require(fallback == 0, f"{fallback} blocks took the host fallback")
    missing = [k for k, n in launches.items() if n == 0]
    require(not missing, f"kernels never launched on the main path: {missing}")
    n_blocks = len(man.blocks)
    print(f"encode: {len(data)} bytes, {n_blocks} blocks -> {len(stream)} "
          f"bytes (ratio {len(stream) / len(data):.4f}) in {t_enc:.3f} s = "
          f"{len(data) / t_enc / 1e6:.2f} MB/s", flush=True)
    print(f"device decode: {len(data)} bytes in {t_dec:.3f} s = "
          f"{len(data) / t_dec / 1e6:.2f} MB/s", flush=True)

    # ---- each kernel against its plain version, main-path operands ------
    def check(kfn, pfn) -> int:
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        return max_abs_err(torch, got, want)

    def timed(fn, reps: int = KERNEL_REPS) -> float:
        return cuda_ms(torch, fn, reps)

    results = []

    def per_call(label, src, rep, mod, calls, kfn, pfn, plain_args=None):
        """Compare and time kernel vs plain version over every call the
        main path made; times are summed over the calls."""
        pa = plain_args or (lambda c: c)
        results.append((
            label, src, rep, mod,
            max(check(lambda c=c: kfn(*pa(c)), lambda c=c: pfn(*pa(c)))
                for c in calls),
            sum(timed(lambda c=c: kfn(*c)) for c in calls),
            sum(timed(lambda c=c: pfn(*pa(c)), 1) for c in calls)))

    def args_of(name):
        out = []
        for a, kw in caps[name].calls:
            out.append(a + tuple(kw.values()))
        return out

    # K1: the three tree batches of the encode (litlen, dist, CL)
    per_call("K1 tree (litlen, dist, CL tree batches of 256)",
             "deflate_tpu_torch/csrc/tree.cu",
             "deflate_tpu/ops/pallas_tree.py:40", "tree", args_of("tree"),
             tree.depths_kernel, tree.depths_plain)
    # K2: every decode bucket
    k2 = args_of("wave_stagea")
    per_call(f"K2 decode_mark ({len(k2)} buckets, W64 "
             f"{'/'.join(str(c[3]) for c in k2)})",
             "deflate_tpu_torch/csrc/wave_stagea.cu",
             "deflate_tpu/ops/wave_stagea.py:73", "wave_stagea", k2,
             wave_stagea.decode_mark_kernel, wave_stagea.decode_mark_plain)
    # K3: every routing call of the decode (4 per bucket)
    k3 = args_of("wave_route")
    per_call(f"K3 route ({len(k3)} calls)",
             "deflate_tpu_torch/csrc/wave_route.cu",
             "deflate_tpu/ops/wave_route.py:46", "wave_route", k3,
             wave_route.route_kernel, wave_route.route_plain)
    # K4: every fill call; the plain per-record loop on 8 blocks of each
    k4 = args_of("wave_fill")
    per_call(f"K4 fill_matches ({len(k4)} buckets; plain_ms on "
             f"{FILL_PLAIN_BLOCKS} blocks of each)",
             "deflate_tpu_torch/csrc/wave_fill.cu",
             "deflate_tpu/ops/wave_fill.py:336", "wave_fill", k4,
             wave_fill.fill_matches_kernel, wave_fill.fill_matches_plain,
             lambda c: tuple(x[:FILL_PLAIN_BLOCKS] for x in c))

    bad = [r[0] for r in results if r[4] != 0]
    for name, _, _, mod, e, ms, pms in results:
        log(f"{name}: max_abs_err {e}, kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms, launches {launches[mod]}")
    require(not bad, f"kernels disagree with their plain versions: {bad}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[mod], "max_abs_err": e, "ms": ms,
         "plain_ms": pms}
        for name, src, rep, mod, e, ms, pms in results]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
