"""Where kernels K8 (stage A at every bit phase) and K2 (fused stages
A+B) spend their time, at the operands of chip_smoke.py's phases E and A
(its 8 MiB corpus: level 3 decoded with DT_STAGEAB_PALLAS=0 for K8,
level 2 decoded with hints for K2).

    python3 tools/stagea_split.py [--tree DIR]

--tree imports deflate_tpu_torch from DIR (for example an unpacked
earlier commit), so two versions are measured in one call.  Times are
CUDA-event means of 20 launches after one warm-up, in ms.  It prints the
card's name and power limit first, then one JSON line:

  ptxas        registers, spills and shared memory of each kernel of
               csrc/wave_stagea.cu (nvcc -Xptxas -v, built in
               deflate_tpu_torch/_build/ptxas/);
  k8.launches  per bucket of phase E: blocks, W64, positions (B x 64 x
               W64), ms (the wrapper, as chip_smoke.py times it),
               device_ms (kernel time under torch.profiler) and
               tables_device_ms (its table build, where the tree has
               one), ns per position (both device times / positions),
               and from the kernel's
               own A0 the share of positions whose litlen code is not
               found within 10, 11 and 12 bits (litlen_slow) and the
               share that decode as a match (match_share);
  k2.launches  per launch of phase A: blocks, W64, chunks, ms (the
               wrapper), kernel_only_ms (the C entry point alone into
               preallocated outputs), device_ms, tables_device_ms,
               host_us (the wrapper's time a call on the host, synchronising
               only after 500 calls: where the card is slower it waits for
               the launch queue), chain steps (the sum of sum_cnt) and ns
               per step (kernel_only_ms / steps);
  k2.host_us_first_call  host µs a call on the first launch's operands
               of the wrapper, its C entry point alone and one
               torch.empty of a hints-sized output;
  sums         k8.sum_ms, k8.sum_device_ms, k2.sum_ms,
               k2.sum_kernel_only_ms, k2.sum_device_ms (device sums
               include the table builds).

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20


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


def host_us(torch, fn, n: int = 500) -> float:
    """Mean host time of fn() over n calls, synchronising only at the
    end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def ptxas(_build, source: str = "wave_stagea",
          names=("decode_mark", "decode_positions", "build_tables")) -> dict:
    """nvcc -Xptxas -v of csrc/<source>.cu: per kernel (keyed by the
    first of `names` its mangled name holds, else by that name),
    registers, spill stores and loads, and shared memory bytes."""
    out_dir = os.path.join(_build.BUILD, "ptxas")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(_build.CSRC, source + ".cu")
    proc = subprocess.run(
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-Xptxas", "-v", "-cubin", "-o",
         os.path.join(out_dir, source + ".cubin"), src],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {source}.cu failed\n{proc.stderr}")
    res, name = {}, None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = next((k for k in names if k in m.group(1)), m.group(1))
            res[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            res[name]["spill_stores"] = int(m.group(1))
            res[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            res[name]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            res[name]["smem"] = int(s.group(1)) if s else 0
    return res


def capture(mod, name: str):
    """Replace mod.name by a wrapper that records its arguments."""
    fn = getattr(mod, name)
    calls = []

    def wrapped(*args):
        calls.append(args)
        return fn(*args)

    setattr(mod, name, wrapped)
    return fn, calls


def k2_launcher(torch, WS, _build, c):
    """The C entry point of K2 alone, into preallocated outputs, on the
    operands of call c; the tree's own launch function where it has one,
    else dt_decode_mark on the md+stop table the old wrapper built."""
    nwords, hints, mds, W64, stop, maxl, maxd = c
    nwords, hints, mds = (x.to(torch.int32).contiguous()
                          for x in (nwords, hints, mds))
    if stop is not None:
        stop = stop.to(torch.int32).contiguous()
    B = nwords.shape[0]
    dev = nwords.device
    a0c = torch.empty((B, 16, W64), dtype=torch.int32, device=dev)
    p1c = torch.empty_like(a0c)
    sums = torch.empty((B, 9, W64), dtype=torch.int32, device=dev)
    if hasattr(WS, "mark_launch"):
        tables = torch.empty((B, WS.TABLE_WORDS), dtype=torch.int32,
                             device=dev)
        return lambda: WS.mark_launch(nwords, hints, mds, stop, a0c, p1c,
                                      sums, tables, W64, maxl, maxd)
    md8 = WS._md8(mds, stop)
    lib = _build.lib("wave_stagea")
    stream = _build.stream_ptr(dev)
    return lambda: lib.dt_decode_mark(
        nwords.data_ptr(), hints.data_ptr(), md8.data_ptr(),
        a0c.data_ptr(), p1c.data_ptr(), sums.data_ptr(), B, W64, maxl,
        maxd, stream)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    tree = os.path.abspath(ap.parse_args().tree)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("stagea_split: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import CORPUS_BYTES, SEED, make_corpus
    from deflate_tpu_torch import _build
    from deflate_tpu_torch.ops import wave_stagea as WS
    from deflate_tpu_torch.runtime import manifest as M

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    data = make_corpus(np.random.default_rng(SEED), CORPUS_BYTES)
    res = {"tree": tree, "card": card, "ptxas": ptxas(_build)}

    # ---- K8 at phase E's operands ---------------------------------------
    s3, m3 = M.compress_with_manifest(data, level=3, device=dev)
    fn8, calls8 = capture(WS, "decode_positions_kernel")
    prev = os.environ.get("DT_STAGEAB_PALLAS")
    os.environ["DT_STAGEAB_PALLAS"] = "0"
    try:
        if M.decode_all(s3, m3, device=dev) != data:
            raise RuntimeError("stagea_split: split decode differs")
    finally:
        WS.decode_positions_kernel = fn8
        if prev is None:
            del os.environ["DT_STAGEAB_PALLAS"]
        else:
            os.environ["DT_STAGEAB_PALLAS"] = prev
    res["k8"] = {"launches": [], "sum_ms": 0.0, "sum_device_ms": 0.0}
    for c in calls8:
        nw, _, W64 = c
        B = int(nw.shape[0])
        pos = B * 64 * W64
        ms = cuda_ms(torch, lambda c=c: fn8(*c))
        dms = device_ms(torch, lambda c=c: fn8(*c), "decode_positions")
        tms = device_ms(torch, lambda c=c: fn8(*c), "build_tables")
        A0 = fn8(*c)[0]
        ln = (A0 >> 26) & 15
        cls = (A0 >> 15) & 3
        notfound = (cls == 3) & (ln == 0)
        slow = {str(k): float(((ln > k) | notfound).float().mean())
                for k in (10, 11, 12)}
        res["k8"]["launches"].append({
            "blocks": B, "W64": W64, "positions": pos, "ms": ms,
            "device_ms": dms, "tables_device_ms": tms,
            "ns_per_position": (dms + tms) * 1e6 / pos,
            "litlen_slow": slow,
            "match_share": float((cls == 1).float().mean())})
        res["k8"]["sum_ms"] += ms
        res["k8"]["sum_device_ms"] += dms + tms

    # ---- K2 at phase A's operands ---------------------------------------
    s, m = M.compress_with_manifest(data, level=2, device=dev)
    fn2, calls2 = capture(WS, "decode_mark_kernel")
    try:
        if M.decode_all(s, m, device=dev) != data:
            raise RuntimeError("stagea_split: hinted decode differs")
    finally:
        WS.decode_mark_kernel = fn2
    res["k2"] = {"launches": [], "sum_ms": 0.0, "sum_kernel_only_ms": 0.0,
                 "sum_device_ms": 0.0}
    for c in calls2:
        nw, W64 = c[0], c[3]
        B = int(nw.shape[0])
        ms = cuda_ms(torch, lambda c=c: fn2(*c))
        launch = k2_launcher(torch, WS, _build, c)
        kms = cuda_ms(torch, launch)
        dms = device_ms(torch, lambda c=c: fn2(*c), "decode_mark")
        tms = device_ms(torch, lambda c=c: fn2(*c), "build_tables")
        steps = int(fn2(*c)[2][:, 5].sum())
        res["k2"]["launches"].append({
            "blocks": B, "W64": W64, "chunks": B * W64, "ms": ms,
            "kernel_only_ms": kms, "device_ms": dms,
            "tables_device_ms": tms,
            "host_us": host_us(torch, lambda c=c: fn2(*c)),
            "steps": steps, "ns_per_step": kms * 1e6 / steps})
        res["k2"]["sum_ms"] += ms
        res["k2"]["sum_kernel_only_ms"] += kms
        res["k2"]["sum_device_ms"] += dms + tms
    c = calls2[0]
    res["k2"]["host_us_first_call"] = {
        "wrapper": host_us(torch, lambda: fn2(*c)),
        "launch_alone": host_us(torch, k2_launcher(torch, WS, _build, c)),
        "torch.empty": host_us(torch, lambda: torch.empty(
            c[1].shape, dtype=torch.int32, device=dev))}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
