"""Where each decode path's time goes on one NVIDIA card.

    python3 tools/chip_phases.py

Runs chip_smoke.py's 8 MiB corpus through nine paths twice — encode,
hinted decode, foreign-stream decode (python zlib level 6, forced onto
the card), hintless decode, level-3 encode, stage C alone on the
level-3 plans through K7's route (encoder.emit_block_packed: packet
fusion, K3 compaction, K7 placement; on no encode path), the hinted
decode of the level-3 stream by the split
stage A (DT_STAGEAB_PALLAS=0: K8, then the mark automaton and
compaction in torch), and the level-2 stream through the speculative
decoder (models/decoder.inflate_device, torch array code, no kernel),
and the public ``compress(data, 2, stats=...)`` (segment encodes of 64
blocks, ``stitch_segments`` on the host, then ``plan_sizes``, the
report's second planning pass over all blocks) — with timers around
each phase (each
timer synchronises the card before and after, so phases do not
overlap), prints each path's breakdown from the second repetition,
then runs each path once more under torch.profiler without the timers
and prints its device kernel time against wall time (the busy share).
Needs a CUDA device.
"""
from __future__ import annotations

import collections
import os
import subprocess
import sys
import time

import zlib

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import deflate_tpu_torch as D  # noqa: E402
from chip_smoke import make_corpus  # noqa: E402
from deflate_tpu_torch import native  # noqa: E402
from deflate_tpu_torch.models import decoder as DEC  # noqa: E402
from deflate_tpu_torch.models import encoder as E  # noqa: E402
from deflate_tpu_torch.models import wave_decoder as WD  # noqa: E402
from deflate_tpu_torch.ops import bitmerge as BM  # noqa: E402
from deflate_tpu_torch.ops import block_inflate as BI  # noqa: E402
from deflate_tpu_torch.ops import header_decode as HD  # noqa: E402
from deflate_tpu_torch.ops import huffman as H  # noqa: E402
from deflate_tpu_torch.ops import inflate_scan as IS  # noqa: E402
from deflate_tpu_torch.ops import lz77 as LZ  # noqa: E402
from deflate_tpu_torch.ops import pack as PK  # noqa: E402
from deflate_tpu_torch.ops import wave as W  # noqa: E402
from deflate_tpu_torch.ops import wave_fill as WF  # noqa: E402
from deflate_tpu_torch.ops import wave_route as WR  # noqa: E402
from deflate_tpu_torch.ops import wave_stagea as WS  # noqa: E402
from deflate_tpu_torch.runtime import manifest as M  # noqa: E402
from deflate_tpu_torch.runtime import stitch as S  # noqa: E402

PHASES = [(E, "_encode"), (LZ, "find_matches"), (LZ, "greedy_parse"),
          (H, "huffman_lengths_batch"), (E, "choose_blocks"),
          (E, "_emit_fields_base"), (E, "_emit_merge_batch"),
          (E, "_emit_fields"), (E, "_packet_pre"), (E, "_route_packets"),
          (E, "_packet_post"), (PK, "pack_blocks"), (E, "_finish_block"),
          (BM, "merge_words"), (E, "block_hints"),
          (W, "parse_headers_host"), (native, "parse_headers"),
          (W, "_canon_meta_batch"), (W, "prepare_windows"),
          (WD, "wave_decode_filled"), (W, "wave_decode"),
          (WS, "decode_mark"), (WS, "decode_mark_split"),
          (WS, "decode_positions"), (W, "chunk_automaton"),
          (W, "chunk_compact"), (WR, "route"), (W, "resolve_litval"),
          (W, "merge_match_runs"), (WF, "pack_fill_recs"),
          (WF, "fill_matches"), (WD, "skeleton_plan"),
          (WD, "_wave_group"), (WF, "fill_matches_hist"),
          (BI, "stream_words"), (BI, "block_windows"), (BI, "inflate_rows"),
          (DEC, "decode_stream"), (DEC, "decode_block"),
          (HD, "parse_dynamic_header"), (IS, "build_lut"),
          (IS, "token_scan"), (IS, "find_chain"), (DEC, "_resolve"),
          (D, "_encode_segments"), (E, "encode_batch"),
          (S, "stitch_segments"), (E, "plan_sizes")]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    data = make_corpus(np.random.default_rng(42), 8 << 20)

    spent = collections.defaultdict(float)
    calls = collections.Counter()
    originals = {}

    def timed(mod, name):
        fn = getattr(mod, name)
        label = f"{mod.__name__.split('.')[-1]}.{name}"

        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                spent[label] += time.perf_counter() - t
                calls[label] += 1
        originals[(mod, name)] = fn
        setattr(mod, name, wrapper)

    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    raw = co.compress(data) + co.flush()
    hs, hm = M.compress_with_manifest(data, hints=False, device=dev)
    state = {}

    def encode():
        state["s"], state["m"] = M.compress_with_manifest(data, device=dev)
        return None

    def encode_l3():
        state["s3"], state["m3"] = M.compress_with_manifest(data, level=3,
                                                            device=dev)
        return None

    # stage C's operands: the level-3 plans of the corpus's blocks
    blocks, blens = (torch.from_numpy(x).to(dev)
                     for x in M.split_blocks(data))
    n = len(blens)
    plans3 = E.batch_plan(blocks, blens, 3)
    choice3, pad3, _, _ = E.choose_blocks(
        plans3["fixed_bits"], plans3["dyn_bits"], blens,
        torch.ones(n, dtype=torch.bool, device=dev), 3)
    args3 = (blocks, blens, plans3, choice3, pad3,
             torch.arange(n, device=dev) == n - 1)
    words3 = E.emit_block(*args3)

    def emit_l3_k7():
        if not torch.equal(E.emit_block_packed(*args3), words3):
            raise RuntimeError("level-3 K7-route words differ")
        return None

    def split_decode():
        os.environ["DT_STAGEAB_PALLAS"] = "0"
        try:
            return M.decode_all(state["s3"], state["m3"], device=dev)
        finally:
            del os.environ["DT_STAGEAB_PALLAS"]

    def compress_stats():
        st = {}
        if D.compress(data, 2, stats=st, device=dev) != state["s"]:
            raise RuntimeError("compress differs from the manifest encode")
        return None

    paths = {
        "encode": encode,
        "decode": lambda: M.decode_all(state["s"], state["m"], device=dev),
        "foreign decode": lambda: D.decompress(
            raw, len(data), device=dev, force_device=True),
        "hintless decode": lambda: M.decode_all(hs, hm, device=dev),
        "L3 encode": encode_l3,
        "L3 stage C, K7 route": emit_l3_k7,
        "L3 split stage-A decode": split_decode,
        "speculative decode": lambda: DEC.inflate_device(
            state["s"], len(data), device=dev),
        "compress, stats": compress_stats,
    }

    for mod, name in PHASES:
        timed(mod, name)
    for rep in range(2):
        report = []
        for what, fn in paths.items():
            spent.clear()
            calls.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if out is not None and out != data:
                raise RuntimeError(f"{what} mismatch")
            report.append((what, wall, dict(spent), dict(calls)))
    for what, wall, sp, cl in report:
        print(f"{what}: {wall * 1e3:.1f} ms")
        for label, sec in sorted(sp.items(), key=lambda kv: -kv[1]):
            print(f"  {label:32s} {sec * 1e3:9.1f} ms  x{cl[label]}")
    for (mod, name), fn in originals.items():
        setattr(mod, name, fn)

    from torch.profiler import ProfilerActivity, profile

    for what, fn in paths.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.device_time for e in kern) / 1e6
        print(f"{what}: wall {wall * 1e3:.1f} ms, device kernel time "
              f"{busy * 1e3:.1f} ms ({100 * busy / wall:.1f}% busy), "
              f"{len(kern)} device events")
    return 0


if __name__ == "__main__":
    sys.exit(main())
