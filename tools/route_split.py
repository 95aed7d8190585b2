"""Where kernel K3's time goes: the route kernels alone against the whole
wrapper, at the operands of the level-2 hinted decode (chip_smoke.py's
phase A: compress_with_manifest, then decode_all, of its 8 MiB corpus).

    python3 tools/route_split.py [--tree DIR]

--tree imports deflate_tpu_torch from DIR (for example an unpacked
earlier commit), so two versions of K3 are measured in one call.  For
the sum over phase A's calls it prints, per call of the wrapper
(`wave_route.route_kernel`), in ms:

  wrapper_ms  CUDA events around 20 back-to-back wrapper calls, as
              chip_smoke.py times every kernel;
  route_ms    device time of the route kernels (kernel names containing
              "route") under torch.profiler over the same 20 calls;
  device_ms   device time of every kernel the wrapper launched
              (the route kernels plus torch's copies and fills);
  host_ms     host wall time of the 20 calls before the final
              synchronisation (the enqueue cost);
  kernels     route_ms by kernel name;
  per_call    each call's payload count, shape, direction and route_ms;
  host_us     host microseconds of single steps of a call, on the first
              call's operands: the wrapper, its launch alone (where the
              tree's wave_route has `launch`), one output's torch.empty,
              and the two current-stream lookups.

Needs a CUDA device; prints the card's name and power limit first and
one JSON line last.
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


def host_us(torch, fn, n: int = 2000) -> float:
    """Mean host time of fn() over n calls, synchronising only at the
    end (the device runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def host_steps(torch, wave_route, c) -> dict:
    pays, delta, rounds, left = c
    dev = delta.device
    out = {"wrapper": host_us(torch, lambda: wave_route.route_kernel(*c)),
           "torch.empty": host_us(torch, lambda: torch.empty(
               delta.shape, dtype=torch.int32, device=dev)),
           "current_stream": host_us(
               torch, lambda: torch.cuda.current_stream(dev).cuda_stream)}
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        out["raw_stream"] = host_us(torch, lambda: raw(dev.index))
    if hasattr(wave_route, "launch"):
        outs = [torch.empty_like(delta) for _ in range(len(pays) + 1)]
        last = torch.empty(
            (delta.shape[0], -(-delta.shape[1] // wave_route.TILE)),
            dtype=torch.int32, device=dev)
        out["launch"] = host_us(torch, lambda: wave_route.launch(
            pays, delta, [o.data_ptr() for o in outs[:-1]],
            outs[-1].data_ptr(), last.data_ptr(), rounds, left))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    tree = os.path.abspath(ap.parse_args().tree)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("route_split: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import CORPUS_BYTES, SEED, make_corpus
    from deflate_tpu_torch.ops import wave_route
    from deflate_tpu_torch.runtime import manifest as M
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    data = make_corpus(np.random.default_rng(SEED), CORPUS_BYTES)
    s, m = M.compress_with_manifest(data, level=2, device=dev)
    fn = wave_route.route_kernel
    calls = []

    def capture(*args):
        calls.append(args)
        return fn(*args)

    wave_route.route_kernel = capture
    try:
        if M.decode_all(s, m, device=dev) != data:
            raise RuntimeError("route_split: decode differs from the corpus")
    finally:
        wave_route.route_kernel = fn

    res = {"tree": tree, "calls": len(calls), "wrapper_ms": 0.0,
           "route_ms": 0.0, "device_ms": 0.0, "host_ms": 0.0,
           "kernels": {}, "per_call": []}
    for c in calls:
        fn(*c)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn(*c)
        host = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        res["wrapper_ms"] += start.elapsed_time(end) / REPS
        res["host_ms"] += host * 1e3 / REPS
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn(*c)
            torch.cuda.synchronize()
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        route_ms = sum(e.device_time for e in kern
                       if "route" in e.name) / 1e3 / REPS
        res["route_ms"] += route_ms
        for e in kern:
            if "route" in e.name:
                name = re.search(r"route\w*", e.name).group(0)
                res["kernels"][name] = res["kernels"].get(name, 0.0) \
                    + e.device_time / 1e3 / REPS
        pays, delta, rounds, left = c
        res["per_call"].append([len(pays), list(delta.shape), bool(left),
                                route_ms])
        res["device_ms"] += sum(e.device_time for e in kern) / 1e3 / REPS
    res["host_us"] = host_steps(torch, wave_route, calls[0])
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
