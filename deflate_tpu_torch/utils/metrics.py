"""Run metrics: the span-and-counter recorder, the profiling helper and the
run report (SURVEY.md §5.1/§5.5).

Port of deflate_tpu/utils/metrics.py.  Reference analog: ad-hoc
`std::cerr` prints and `#ifdef DEBUG` chrono timers around the matchers
(deflate.hpp:270-303, 312-382).

The recorder marks the layer boundaries of the encode and decode paths:

    with span("encode.emit"):          # a stage of an op
        ...
    count("copy.h2d")                   # an event, always counted
    with recording(sync=True):         # spans record only in here
        ...
    snapshot()  # {"spans": {name: {"n", "total_s", "self_s",
                #                    "wait_s", "sync_s"}},
                #  "counts": {name: n}, "ops": n}

While recording is off (the default) ``span`` returns one shared no-op
context: one flag test, no clock, no synchronisation.  While it is on,
each span keeps (name, id, parent id, op id, start_ns, end_ns) stamped
by ``time.time_ns()``, the clock the torch profiler stamps host events
with; the outermost open span is an op, and the spans nested in it
carry its id.  Under an active torch profiler a span also opens a
profiler range named SPAN_PREFIX + name on the host timeline, so the
trace carries the same intervals.  Spans nest on one thread.

Beside its row each span keeps the nanoseconds the host spent blocked
on the card while it was the innermost open span, in two sums.  Its
wait: the program's own blocking, in to_device's and to_host's copies
across and in sync_stream.  Its sync: the recorder's own
synchronisations (a span's opening one waits for its parent's work and
is charged to the parent, its closing one to itself), which an
unrecorded run never makes.  While recording is off nothing is timed.
"""
from __future__ import annotations

import contextlib
import json
import time

import numpy as np

SPAN_PREFIX = "dt."         # every program span's name in a profile

_on = False                 # spans record
_sync = None                # torch.cuda.synchronize while spans synchronise
_stack: list = []           # open spans, innermost last
_spans: list = []           # closed: (name, id, parent, op, start_ns, end_ns)
_host: dict = {}            # closed span's id: (wait_ns, sync_ns)
_ops: list = []             # (op id, under a profiler, the op's counts)
_counts: dict = {}          # every count since the last reset()
_op_counts = None           # the open op's counts while recording
_next_id = 0


def _profiling() -> bool:
    import torch

    return torch._C._autograd._profiler_enabled()


def _waited(t0: int) -> None:
    """Charge the program's wait since t0 (time.time_ns) to the innermost
    open span, if any."""
    if _stack:
        _stack[-1].wait += time.time_ns() - t0


def _synced() -> None:
    """The recorder's synchronisation, charged to the innermost open
    span's sync, if any."""
    t0 = time.time_ns()
    _sync()
    if _stack:
        _stack[-1].sync += time.time_ns() - t0


class _Off:
    """The context span() returns while recording is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "parent", "op", "start", "rf", "wait",
                 "sync")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _next_id, _op_counts
        profiled = _profiling()
        if _sync is not None and not profiled:
            _synced()                   # the parent's work, before self
        self.wait = self.sync = 0
        self.id = _next_id
        _next_id += 1
        if _stack:
            self.parent = _stack[-1].id
            self.op = _stack[-1].op
        else:
            self.parent = None
            self.op = self.id
            _op_counts = {}
            _ops.append((self.id, profiled, _op_counts))
        _stack.append(self)
        self.rf = None
        if profiled:
            import torch

            # a host range alone: a record_function (user) range would
            # also put a range on the card's timeline, over the kernels
            # launched in it, that a reader of the device trace takes
            # for device work
            self.rf = torch._C._profiler._RecordFunctionFast(
                SPAN_PREFIX + self.name)
            self.rf.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _op_counts
        if _sync is not None and self.rf is None:
            _synced()
        end = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack.pop()
        if not _stack:
            _op_counts = None
        _spans.append((self.name, self.id, self.parent, self.op, self.start,
                       end))
        _host[self.id] = (self.wait, self.sync)
        return False


def span(name: str):
    """A context that records one interval of the program under `name`
    while recording is on; a shared no-op context otherwise."""
    if not _on:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`; counts whether or not spans record."""
    _counts[name] = _counts.get(name, 0) + n
    if _op_counts is not None:
        _op_counts[name] = _op_counts.get(name, 0) + n


def start(sync: bool) -> None:
    """Switch recording on.  sync: each span synchronises the card at its
    start and end, so that its time holds the device work it enqueued
    (never under an active profiler, whose idle gaps must stay the
    program's own); without it spans only mark the timeline.  Keeps what
    was recorded before."""
    import torch

    global _on, _sync
    _on = True
    _sync = (torch.cuda.synchronize
             if sync and torch.cuda.is_available() else None)


def stop() -> None:
    global _on, _sync
    _on, _sync = False, None


@contextlib.contextmanager
def recording(sync: bool):
    """Spans record in the body (see start()); the state before is
    restored after it."""
    global _on, _sync
    prev = (_on, _sync)
    start(sync)
    try:
        yield
    finally:
        _on, _sync = prev


def reset() -> None:
    """Forget every recorded span, op and count."""
    global _op_counts
    _spans.clear()
    _host.clear()
    _ops.clear()
    _counts.clear()
    _op_counts = None


def snapshot(profiled: bool | None = None) -> dict:
    """What was recorded since the last reset(): per span name its number
    of intervals, their summed seconds and their self seconds (less the
    part that their child spans cover), the seconds the host was blocked
    on the card in them by the program (wait_s) and by the recorder's
    synchronisations (sync_s), the counts, and the number of ops.
    profiled=None: every span and every count; False or True: only the
    ops that ran without or under a torch profiler, with the counts made
    inside them."""
    if profiled is None:
        keep = None
        counts = dict(_counts)
        nops = len(_ops)
    else:
        ops = [(op, c) for op, p, c in _ops if p == profiled]
        keep = {op for op, _ in ops}
        counts = {}
        for _, c in ops:
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
        nops = len(ops)
    child = {}
    for name, sid, parent, op, s, e in _spans:
        if parent is not None and (keep is None or op in keep):
            child[parent] = child.get(parent, 0) + (e - s)
    out = {}
    for name, sid, parent, op, s, e in _spans:
        if keep is not None and op not in keep:
            continue
        d = out.setdefault(name, {"n": 0, "total_s": 0.0, "self_s": 0.0,
                                  "wait_s": 0.0, "sync_s": 0.0})
        wait, sync = _host[sid]
        d["n"] += 1
        d["total_s"] += (e - s) * 1e-9
        d["self_s"] += (e - s - child.get(sid, 0)) * 1e-9
        d["wait_s"] += wait * 1e-9
        d["sync_s"] += sync * 1e-9
    return {"spans": out, "counts": counts, "ops": nops}


def to_device(a, device):
    """A numpy array or tensor on `device`, counted as copy.h2d and
    copy.h2d_bytes where it crosses from the host; while recording, that
    blocking copy (the card's work before it, and the copy) is a wait of
    the innermost open span."""
    import torch

    t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    if _on:
        t0 = time.time_ns()
        out = t.to(device)
        if out.device != t.device:
            _waited(t0)
    else:
        out = t.to(device)
    if out.device != t.device:
        count("copy.h2d")
        count("copy.h2d_bytes", t.numel() * t.element_size())
    return out


def to_host(t):
    """t on the host, counted as copy.d2h and copy.d2h_bytes where it
    comes from a device; while recording, the blocking read (the card's
    work before the copy, and the copy) is a wait of the innermost open
    span."""
    if t.device.type != "cpu":
        count("copy.d2h")
        count("copy.d2h_bytes", t.numel() * t.element_size())
        if _on:
            t0 = time.time_ns()
            out = t.cpu()
            _waited(t0)
            return out
    return t.cpu()


def sync_stream(device) -> None:
    """Block the host until `device`'s current stream has run what was
    enqueued on it; while recording, the wait is the innermost open
    span's."""
    import torch

    stream = torch.cuda.current_stream(device)
    if not _on:
        stream.synchronize()
        return
    t0 = time.time_ns()
    stream.synchronize()
    _waited(t0)


def _count_pinned(kind: str, t) -> None:
    n = t.numel() * t.element_size()
    count(kind)
    count(kind + "_bytes", n)
    count("copy.pinned")
    count("copy.pinned_bytes", n)


def to_device_pinned(t, device):
    """t, a page-locked host tensor, on `device` by one copy that does
    not block the host; counted as copy.h2d and copy.pinned, with their
    _bytes, where it crosses to a device (t itself on the host)."""
    out = t.to(device, non_blocking=True)
    if out.device != t.device:
        _count_pinned("copy.h2d", t)
    return out


def to_host_pinned(t):
    """t in a new page-locked host tensor by one copy that does not
    block the host: the caller synchronises t's stream before it reads
    the result.  Counted as copy.d2h and copy.pinned, with their _bytes,
    where t is on a device (t itself on the host)."""
    import torch

    if t.device.type == "cpu":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    _count_pinned("copy.d2h", t)
    return out.copy_(t, non_blocking=True)


@contextlib.contextmanager
def profile_to(logdir: str):
    """Capture a host and device trace of the region, written to logdir
    as a Chrome trace (trace.json), viewable in Perfetto; the program's
    spans record in it without synchronising, as SPAN_PREFIX ranges."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        with recording(sync=False):
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
