"""Where the main path's time goes on one NVIDIA card.

    python3 tools/chip_phases.py

Encodes and decodes chip_smoke.py's 8 MiB corpus twice with timers
around each phase (each timer synchronises the card before and after,
so phases do not overlap), prints the second repetition's breakdown,
then runs each half once more under torch.profiler without the timers
and prints its device kernel time against wall time (the busy share).
Needs a CUDA device.
"""
from __future__ import annotations

import collections
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import make_corpus  # noqa: E402
from deflate_tpu_torch.models import encoder as E  # noqa: E402
from deflate_tpu_torch.models import wave_decoder as WD  # noqa: E402
from deflate_tpu_torch.ops import bitmerge as BM  # noqa: E402
from deflate_tpu_torch.ops import huffman as H  # noqa: E402
from deflate_tpu_torch.ops import lz77 as LZ  # noqa: E402
from deflate_tpu_torch.ops import wave as W  # noqa: E402
from deflate_tpu_torch.ops import wave_fill as WF  # noqa: E402
from deflate_tpu_torch.ops import wave_route as WR  # noqa: E402
from deflate_tpu_torch.ops import wave_stagea as WS  # noqa: E402
from deflate_tpu_torch.runtime import manifest as M  # noqa: E402

PHASES = [(E, "_encode"), (LZ, "find_matches"), (LZ, "greedy_parse"),
          (H, "huffman_lengths_batch"), (E, "choose_blocks"),
          (E, "_emit_fields_base"), (E, "_emit_merge_batch"),
          (BM, "merge_words"), (E, "block_hints"),
          (W, "parse_headers_host"), (W, "prepare_windows"),
          (WD, "wave_decode_filled"), (W, "wave_decode"),
          (WS, "decode_mark"), (WR, "route"), (W, "resolve_litval"),
          (W, "merge_match_runs"), (WF, "pack_fill_recs"),
          (WF, "fill_matches")]


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

    for mod, name in PHASES:
        timed(mod, name)
    for rep in range(2):
        spent.clear()
        calls.clear()
        t0 = time.perf_counter()
        stream, man = M.compress_with_manifest(data, device=dev)
        t1 = time.perf_counter()
        if M.decode_all(stream, man, device=dev) != data:
            raise RuntimeError("decode mismatch")
        t2 = time.perf_counter()
        print(f"rep {rep}: encode {t1 - t0:.3f} s, decode {t2 - t1:.3f} s")
    for label, sec in sorted(spent.items(), key=lambda kv: -kv[1]):
        print(f"  {label:32s} {sec * 1e3:9.1f} ms  x{calls[label]}")
    for (mod, name), fn in originals.items():
        setattr(mod, name, fn)

    from torch.profiler import ProfilerActivity, profile

    for what in ("encode", "decode"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if what == "encode":
                stream, man = M.compress_with_manifest(data, device=dev)
            else:
                M.decode_all(stream, man, device=dev)
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
