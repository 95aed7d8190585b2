"""Where kernels K6 (block inflate) and K4 (match fill) spend their time,
at the operands of chip_smoke.py's phases C and A (its 8 MiB corpus of
256 blocks: quarters of lowercase text, 509-byte repeats, 6-letter words
and random bytes).

    python3 tools/k6_split.py [--tree DIR]

--tree imports deflate_tpu_torch from DIR (for example an unpacked
earlier commit), so two versions are measured in one call.  Times are
CUDA-event means of 20 launches after one warm-up, in ms.  It prints the
card's name and power limit first, then one JSON line:

  k6.all_ms       K6 on phase C's 256 blocks in one launch (as phase C),
                  and k6.all_device_ms;
  k6.quarters     per corpus quarter: K6 on its 64 blocks alone (ms, and
                  device_ms: the kernel's device time under
                  torch.profiler), on its first block alone (one_ms: one
                  decode chain on an idle card), and from the plain
                  decode on the host (block_inflate.decode_tokens, where
                  the tree has it): symbols (literals + matches + end of
                  block; none in a stored block) of the slowest block and
                  on average, literals (stored bytes included), matches
                  and match bytes per block, and ns per symbol of the
                  quarter's slowest block (device_ms / symbols_max);
  k4.launches     K4 on each of phase A's buckets: rows, records, ms,
                  device_ms;
  k4.sum_ms       their sum (chip_smoke.py's K4 number), and
                  k4.sum_device_ms.

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20
QUARTERS = ("text", "repeats", "words", "random")


def cuda_ms(torch, fn, reps: int = REPS) -> float:
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


def device_ms(torch, fn, kernel: str, reps: int = REPS) -> float:
    """Device time per call of the kernels whose names hold `kernel`,
    under torch.profiler over reps calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and kernel in e.name) / 1e3 / reps


def token_counts(BI, ops, stored) -> list[dict] | None:
    """Per block: symbols, literals, matches and match bytes, from the
    plain token decode on the host (None where the tree has no
    decode_tokens)."""
    if not hasattr(BI, "decode_tokens"):
        return None
    _, rec0, _, nmatch, status = BI.decode_tokens(*(x.cpu() for x in ops))
    out = []
    for b in range(len(nmatch)):
        n = int(nmatch[b])
        mbytes = int(((rec0[b, :n].astype(np.int64) >> 16) + 3).sum())
        lits = int(status[b, 0]) - mbytes
        out.append({"literals": lits, "matches": n, "match_bytes": mbytes,
                    "symbols": 0 if stored[b] else lits + n + 1})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    tree = os.path.abspath(ap.parse_args().tree)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("k6_split: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import CORPUS_BYTES, SEED, make_corpus
    from deflate_tpu_torch.ops import block_inflate as BI
    from deflate_tpu_torch.ops import wave_fill as WF
    from deflate_tpu_torch.runtime import manifest as M

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    data = make_corpus(np.random.default_rng(SEED), CORPUS_BYTES)

    # ---- K6 at phase C's operands ---------------------------------------
    hs, hm = M.compress_with_manifest(data, level=2, hints=False, device=dev)
    offs = [b[0] for b in hm.blocks]
    ops = [torch.from_numpy(x).to(dev)
           for x in (*BI.prepare_blocks(hs, offs), BI.make_statics())]
    words, start_w, bit0, avail, statics = ops
    nb = start_w.shape[0]
    if nb != 4 * 64:
        raise RuntimeError(f"k6_split: {nb} blocks, expected 256")
    out, status = BI.inflate_blocks_kernel(*ops)
    torch.cuda.synchronize()
    got = b"".join(out[i].cpu().numpy().view(np.uint8)[:int(status[i, 0])]
                   .tobytes() for i in range(nb))
    if got != data or int(status[:, 1].abs().sum()):
        raise RuntimeError("k6_split: K6 does not decode phase C's corpus")
    stored = [(int.from_bytes(hs[o >> 3:(o >> 3) + 2], "little")
               >> ((o & 7) + 1)) & 3 == 0 for o in offs]
    counts = token_counts(BI, ops, stored)

    def sub(ix):
        return (words, start_w[ix], bit0[ix], avail[ix], statics)

    res = {"tree": tree, "card": card, "k6": {
        "all_ms": cuda_ms(torch, lambda: BI.inflate_blocks_kernel(*ops)),
        "all_device_ms": device_ms(
            torch, lambda: BI.inflate_blocks_kernel(*ops), "inflate"),
        "quarters": []}}
    for q, name in enumerate(QUARTERS):
        ix = torch.arange(64 * q, 64 * (q + 1), device=dev)
        args = sub(ix)
        ms = cuda_ms(torch, lambda: BI.inflate_blocks_kernel(*args))
        dev_ms = device_ms(torch, lambda: BI.inflate_blocks_kernel(*args),
                           "inflate")
        one = sub(ix[:1])
        one_ms = cuda_ms(torch, lambda: BI.inflate_blocks_kernel(*one))
        row = {"quarter": name, "blocks": f"{64 * q}-{64 * q + 63}",
               "ms": ms, "device_ms": dev_ms, "one_ms": one_ms}
        if counts:
            c = counts[64 * q:64 * (q + 1)]
            sym = [x["symbols"] for x in c]
            row.update({"symbols_max": max(sym),
                        "symbols_mean": float(np.mean(sym)),
                        "ns_per_symbol": (dev_ms * 1e6 / max(sym)
                                          if max(sym) else None)})
            for k in ("literals", "matches", "match_bytes"):
                row[k + "_mean"] = float(np.mean([x[k] for x in c]))
        res["k6"]["quarters"].append(row)

    # ---- K4 at phase A's operands ---------------------------------------
    s, m = M.compress_with_manifest(data, level=2, device=dev)
    fn = WF.fill_matches_kernel
    calls = []

    def capture(*args):
        calls.append(args)
        return fn(*args)

    WF.fill_matches_kernel = capture
    try:
        if M.decode_all(s, m, device=dev) != data:
            raise RuntimeError("k6_split: hinted decode differs")
    finally:
        WF.fill_matches_kernel = fn
    res["k4"] = {"launches": [], "sum_ms": 0.0, "sum_device_ms": 0.0}
    for c in calls:
        ms = cuda_ms(torch, lambda c=c: fn(*c))
        dev_ms = device_ms(torch, lambda c=c: fn(*c), "fill")
        res["k4"]["launches"].append({
            "rows": int(c[0].shape[0]),
            "records": int(c[2].clamp(min=0).sum()), "ms": ms,
            "device_ms": dev_ms})
        res["k4"]["sum_ms"] += ms
        res["k4"]["sum_device_ms"] += dev_ms
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
