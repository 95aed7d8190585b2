"""Structured run metrics and profiling harness (SURVEY.md §5.1/§5.5).

Port of deflate_tpu/utils/metrics.py.  Reference analog: ad-hoc
`std::cerr` prints and `#ifdef DEBUG` chrono timers around the matchers
(deflate.hpp:270-303, 312-382).  Here every run can emit one JSON report
— ratio, throughput, block-type histogram — and hot sections can be
wrapped in `torch.profiler` ranges, viewable in Perfetto.
"""
from __future__ import annotations

import contextlib
import json
import time


@contextlib.contextmanager
def trace(name: str, enabled: bool = True):
    """torch.profiler range annotation around a code region (no-op if
    off)."""
    if not enabled:
        yield
        return
    import torch

    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile_to(logdir: str):
    """Capture a host and device trace of the region, written to logdir
    as a Chrome trace (trace.json), viewable in Perfetto."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class RunReport:
    """Accumulates per-run codec statistics, emitted as one JSON line."""

    def __init__(self, op: str):
        self.op = op
        self.t0 = time.perf_counter()
        self.bytes_in = 0
        self.bytes_out = 0
        self.block_types = {"stored": 0, "fixed": 0, "dynamic": 0}
        self.extra: dict = {}

    def add_blocks(self, choices):
        """choices: iterable of 0/1/2 block-type codes (encoder CH_*)."""
        names = ["stored", "fixed", "dynamic"]
        for c in choices:
            self.block_types[names[int(c)]] += 1

    def finish(self) -> dict:
        dt = time.perf_counter() - self.t0
        ratio = (self.bytes_out / self.bytes_in) if self.bytes_in else None
        return {
            "op": self.op,
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
            "ratio": round(ratio, 4) if ratio is not None else None,
            "seconds": round(dt, 4),
            "mb_per_s": round(self.bytes_in / dt / 1e6, 2) if dt else None,
            "block_types": self.block_types,
            **self.extra,
        }

    def emit(self, stream=None) -> str:
        line = json.dumps(self.finish())
        if stream is not None:
            print(line, file=stream)
        return line
