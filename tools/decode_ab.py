"""Time the hinted device decode of chip_smoke.py's corpus in one tree.

    python3 tools/decode_ab.py [--tree DIR] [--reps N]

--tree imports deflate_tpu_torch from DIR (for example an unpacked
earlier commit), so two versions are compared in one call on the same
card: run parent, change, change, parent.  Encodes the 8 MiB corpus at
level 2 with hints, checks the decode, then times ``inflate_wave_device``
(the bucketed wavefront decode: operands to the card, stages A-F and the
match fill, results back) and ``decode_all`` (the same plus the byte
assembly) over N warm repetitions each, the card synchronised around
every one.  Prints the card (nvidia-smi name and power limit) and one
JSON line: the tree, every repetition's seconds, their median and the
median's MB/s.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import CORPUS_BYTES, SEED, make_corpus
    from deflate_tpu_torch.models import wave_decoder as WD
    from deflate_tpu_torch.runtime import manifest as M

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    data = make_corpus(np.random.default_rng(SEED), CORPUS_BYTES)
    s, m = M.compress_with_manifest(data, level=2, device=dev)
    offs = [b[0] for b in m.blocks]
    sizes = [b[2] for b in m.blocks]
    hints = m.hint_array()
    if M.decode_all(s, m, device=dev) != data:
        raise RuntimeError("decode_ab: decode differs from the corpus")

    def timed(fn) -> list[float]:
        fn()
        out = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out

    res = {"tree": tree, "card": card, "reps": args.reps}
    for name, fn in (
            ("inflate_wave_device", lambda: WD.inflate_wave_device(
                s, offs, sizes, hints, device=dev)),
            ("decode_all", lambda: M.decode_all(s, m, device=dev))):
        t = timed(fn)
        res[name] = {"s": t, "median_s": statistics.median(t),
                     "mbps": len(data) / 1e6 / statistics.median(t)}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
