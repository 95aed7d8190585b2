"""Where kernel K1 (the batched Huffman depth build) spends its time, at
the operands of chip_smoke.py's phase A (its 8 MiB corpus encoded at
level 2: one launch each for the litlen, distance and code-length trees
of 256 blocks).

    python3 tools/tree_split.py [--tree DIR]

--tree imports deflate_tpu_torch from DIR (for example an unpacked
earlier commit), so two versions are measured in one call.  Times are
CUDA-event means of 20 launches after one warm-up, in ms.  It prints the
card's name and power limit first, then one JSON line:

  ptxas       registers, spills and shared memory of each kernel of
              csrc/tree.cu (nvcc -Xptxas -v, built in
              deflate_tpu_torch/_build/ptxas/; stagea_split.ptxas);
  launches    per K1 call of phase A: trees, n (alphabet size), nz_max and
              nz_mean (used symbols a tree), merge_steps (the sum of
              nz - 1 over the trees), ms (the wrapper, as chip_smoke.py
              times it), kernel_only_ms (the C entry point alone into a
              preallocated output), device_ms (kernel time under
              torch.profiler), ns_per_step (device_ms over merge_steps:
              the trees run side by side, so this is a launch's time
              shared out, not one chain's step) and host_us (the
              wrapper's host time a call, synchronising only after 500
              calls);
  sums        sum_ms, sum_kernel_only_ms, sum_device_ms over the three.

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

from stagea_split import cuda_ms, device_ms, host_us, ptxas

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launcher(torch, tree, _build, lw, nz):
    """The C entry point of K1 alone into a preallocated output: the
    tree's own launch function where it has one, else dt_tree_depths."""
    lw = lw.to(torch.int32).contiguous()
    nz = nz.to(torch.int32).contiguous()
    out = torch.empty((lw.shape[0], tree.NW), dtype=torch.int32,
                      device=lw.device)
    if hasattr(tree, "depths_launch"):
        return lambda: tree.depths_launch(lw, nz, out)
    fn = _build.lib("tree").dt_tree_depths
    stream = _build.stream_ptr(lw.device)
    T, n = lw.shape
    return lambda: fn(lw.data_ptr(), nz.data_ptr(), out.data_ptr(), T, n,
                      stream)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    src_tree = os.path.abspath(ap.parse_args().tree)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, src_tree)

    import torch

    if not torch.cuda.is_available():
        print("tree_split: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import CORPUS_BYTES, SEED, make_corpus
    from deflate_tpu_torch import _build
    from deflate_tpu_torch.ops import tree
    from deflate_tpu_torch.runtime import manifest as M

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    data = make_corpus(np.random.default_rng(SEED), CORPUS_BYTES)
    res = {"tree": src_tree, "card": card,
           "ptxas": ptxas(_build, "tree", names=())}

    M.compress_with_manifest(data, level=2, device=dev)      # warm-up
    fn = tree.depths_kernel
    calls = []

    def wrapped(*args):
        calls.append(args)
        return fn(*args)

    tree.depths_kernel = wrapped
    try:
        M.compress_with_manifest(data, level=2, device=dev)
    finally:
        tree.depths_kernel = fn
    if len(calls) != 3:
        raise RuntimeError(f"tree_split: phase A made {len(calls)} K1 "
                           "calls, not 3")
    res["launches"] = []
    sums = {"sum_ms": 0.0, "sum_kernel_only_ms": 0.0, "sum_device_ms": 0.0}
    for lw, nz in calls:
        if not torch.equal(fn(lw, nz), tree.depths_plain(lw, nz)):
            raise RuntimeError("tree_split: K1 differs from depths_plain")
        nzh = nz.to(torch.int64).cpu()
        steps = int((nzh - 1).clamp(min=0).sum())
        ms = cuda_ms(torch, lambda: fn(lw, nz))
        kms = cuda_ms(torch, launcher(torch, tree, _build, lw, nz))
        dms = device_ms(torch, lambda: fn(lw, nz), "tree_depths")
        res["launches"].append({
            "trees": int(lw.shape[0]), "n": int(lw.shape[1]),
            "nz_max": int(nzh.max()), "nz_mean": float(nzh.double().mean()),
            "merge_steps": steps, "ms": ms, "kernel_only_ms": kms,
            "device_ms": dms, "ns_per_step": dms * 1e6 / max(steps, 1),
            "host_us": host_us(torch, lambda: fn(lw, nz))})
        sums["sum_ms"] += ms
        sums["sum_kernel_only_ms"] += kms
        sums["sum_device_ms"] += dms
    res.update(sums)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
