"""Where kernel K7 (the per-block bit placement of the kernel emission
backend) spends its time, at the operands of chip_smoke.py's phase D
(its 8 MiB corpus encoded at level 3 with pack="kernel": one launch over
256 blocks).

    python3 tools/pack_split.py [--tree DIR]

--tree imports deflate_tpu_torch from DIR (for example an unpacked
earlier commit), so two versions are measured in one call.  Times are
CUDA-event means of 20 launches after one warm-up, in ms.  It prints the
card's name and power limit first, then one JSON line:

  ptxas         registers, spills and shared memory of each kernel of
                csrc/pack.cu (nvcc -Xptxas -v, built in
                deflate_tpu_torch/_build/ptxas/; stagea_split.ptxas);
  ms            the wrapper, as chip_smoke.py times it;
  kernel_only_ms  the C entry point alone into a preallocated output;
  device_ms     kernel time under torch.profiler;
  host_us       the wrapper's host time a call, synchronising only
                after 500 calls;
  library_ms    one torch index_add_ of the live packets' nonzero words
                (chip_smoke.py's yardstick);
  bound_bytes, bound_ms, gbps  the bytes the call must move (12 a live
                packet, the counts, the output), over 3.35 TB/s, and
                over device_ms;
  quarters      per corpus quarter's 64 blocks (text, repeats, words,
                random): packets, zero_payload packets, live_words (up
                to each block's last live word, (off[count-1] >> 5) + 3,
                at most OUTW), nonzero_words of the output, ms and
                device_ms of the wrapper on those blocks alone.

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

from stagea_split import capture, cuda_ms, device_ms, host_us, ptxas

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12
QUARTERS = ("text", "repeats", "words", "random")


def launcher(torch, pack, _build, c):
    """The C entry point of K7 alone into a preallocated output: the
    tree's own launch function where it has one, else dt_pack_blocks."""
    c = [x.to(torch.int32).contiguous() for x in c]
    out = torch.empty((c[0].shape[0], pack.OUTW), dtype=torch.int32,
                      device=c[0].device)
    if hasattr(pack, "pack_launch"):
        return lambda: pack.pack_launch(*c, out)
    fn = _build.lib("pack").dt_pack_blocks
    stream = _build.stream_ptr(out.device)
    B = c[0].shape[0]
    return lambda: fn(*(x.data_ptr() for x in c), out.data_ptr(), B,
                      pack.NPK, pack.OUTW, stream)


def library(torch, pack, wrap32, c):
    """chip_smoke.py's yardstick: index_add_ of the live packets' nonzero
    words below OUTW into the flat output, prepared beforehand."""
    idx, vals = pack.packet_words(*c)
    B = idx.shape[0]
    rows = torch.arange(B, device=idx.device)[:, None]
    keep = (idx < pack.OUTW) & (vals != 0)
    flat = (rows * pack.OUTW + idx)[keep]
    vals = wrap32(vals[keep])
    dest = torch.zeros(B * pack.OUTW, dtype=torch.int32, device=idx.device)
    return lambda: dest.index_add_(0, flat, vals)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    src_tree = os.path.abspath(ap.parse_args().tree)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, src_tree)

    import torch

    if not torch.cuda.is_available():
        print("pack_split: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import CORPUS_BYTES, SEED, make_corpus
    from deflate_tpu_torch import _build
    from deflate_tpu_torch.models import encoder as E
    from deflate_tpu_torch.ops import pack
    from deflate_tpu_torch.runtime import manifest as M
    from deflate_tpu_torch.utils.bits import wrap32

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    data = make_corpus(np.random.default_rng(SEED), CORPUS_BYTES)
    res = {"tree": src_tree, "card": card,
           "ptxas": ptxas(_build, "pack", names=())}

    blocks, blens = M.split_blocks(data)
    n = len(blens)

    def encode():
        return E.encode_batch_with_hints(
            torch.from_numpy(blocks).to(dev), torch.from_numpy(blens).to(dev),
            torch.ones(n, dtype=torch.bool, device=dev), n - 1, 3, 0,
            pack="kernel")

    encode()                                               # warm-up
    fn, calls = capture(pack, "pack_blocks_kernel")
    try:
        encode()
    finally:
        pack.pack_blocks_kernel = fn
    if len(calls) != 1:
        raise RuntimeError(f"pack_split: phase D made {len(calls)} K7 "
                           "calls, not 1")
    c = calls[0]
    if not torch.equal(fn(*c), pack.pack_blocks_plain(*c)):
        raise RuntimeError("pack_split: K7 differs from pack_blocks_plain")
    counts, off, lo, hi = c
    npk = int(counts.clamp(0, pack.NPK).sum())
    bound = 12 * npk + counts.numel() * 4 + counts.shape[0] * pack.OUTW * 4
    dms = device_ms(torch, lambda: fn(*c), "pack")
    res.update({
        "blocks": int(counts.shape[0]), "packets": npk,
        "ms": cuda_ms(torch, lambda: fn(*c)),
        "kernel_only_ms": cuda_ms(torch, launcher(torch, pack, _build, c)),
        "device_ms": dms, "host_us": host_us(torch, lambda: fn(*c)),
        "library_ms": cuda_ms(torch, library(torch, pack, wrap32, c)),
        "bound_bytes": bound, "bound_ms": bound / HBM_BYTES_PER_S * 1e3,
        "gbps": bound / (dms * 1e-3) / 1e9 if dms else None})

    lane = torch.arange(pack.NPK, device=dev)[None, :]
    live = lane < counts[:, None]
    zero = live & (lo == 0) & (hi == 0)
    nz = counts.clamp(0, pack.NPK).to(torch.int64)
    lastw = torch.where(
        nz > 0, off.gather(1, (nz - 1).clamp(min=0)[:, None])[:, 0]
        .to(torch.int64) // 32 + 3, 0).clamp(max=pack.OUTW)
    words = fn(*c)
    res["quarters"] = {}
    for q, name in enumerate(QUARTERS):
        ix = slice(64 * q, 64 * (q + 1))
        cq = [x[ix] for x in c]
        res["quarters"][name] = {
            "packets": int(nz[ix].sum()),
            "zero_payload": int(zero[ix].sum()),
            "live_words": int(lastw[ix].sum()),
            "nonzero_words": int((words[ix] != 0).sum()),
            "ms": cuda_ms(torch, lambda: fn(*cq)),
            "device_ms": device_ms(torch, lambda: fn(*cq), "pack")}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
