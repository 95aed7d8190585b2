"""Spans and the device trace of a traced run.

Spans wrap functions of the program from outside, by replacing the
module attribute that its callers look up, and are installed only in a
traced run.  Two kinds:

- ``timed``: synchronises the card before and after the call and adds
  the host seconds between to the span's total (the window's per-layer
  times);
- ``labelled``: marks the call in the profiler's host timeline without
  synchronising (the profiled slice, whose idle gaps it names).

``reduce`` turns the profiler's events into the device's busy time, its
kernel time and the breakdown; its arithmetic works on plain tuples so
that tests can feed it synthetic intervals.
"""
from __future__ import annotations

import bisect
import collections
import importlib
import time

WINDOW = "codecbench.window"
OP = "codecbench.op"
SPAN = "codecbench.span:"


class Patches:
    """Module attributes replaced by wrappers, restored by undo()."""

    def __init__(self):
        self.saved = []

    def wrap(self, modname: str, fn: str, make) -> None:
        mod = importlib.import_module(modname)
        orig = getattr(mod, fn)
        setattr(mod, fn, make(orig))
        self.saved.append((mod, fn, orig))

    def undo(self) -> None:
        while self.saved:
            mod, fn, orig = self.saved.pop()
            setattr(mod, fn, orig)


def timed(spans, totals: dict, sync) -> Patches:
    """Install synchronised timers on (module, function) spans; each adds
    its seconds to totals["module.function"]."""
    p = Patches()
    for modname, fn in spans:
        label = f"{modname}.{fn}"

        def make(orig, label=label):
            def wrapper(*a, **k):
                sync()
                t = time.perf_counter()
                try:
                    return orig(*a, **k)
                finally:
                    sync()
                    totals[label] = totals.get(label, 0.0) + (
                        time.perf_counter() - t)
            return wrapper
        p.wrap(modname, fn, make)
    return p


def labelled(spans) -> Patches:
    """Mark each call of the spans in the profiler's host timeline."""
    from torch.profiler import record_function

    p = Patches()
    for modname, fn in spans:
        name = f"{SPAN}{modname.split('.')[-1]}.{fn}"

        def make(orig, name=name):
            def wrapper(*a, **k):
                with record_function(name):
                    return orig(*a, **k)
            return wrapper
        p.wrap(modname, fn, make)
    return p


def union(intervals) -> list[tuple[float, float]]:
    """Merge (start, end) intervals into disjoint sorted ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def gaps(busy, w0: float, w1: float) -> list[tuple[float, float]]:
    """The idle stretches of [w0, w1] outside the merged busy intervals."""
    out, t = [], w0
    for s, e in busy:
        s, e = max(s, w0), min(e, w1)
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if w1 > t:
        out.append((t, w1))
    return out


def host_labels(host):
    """A function of a time t: the innermost labelled host span (name,
    start, end) covering t, the op itself where no span does, "between
    ops" outside every op.  Spans nest, so the innermost span covering t
    is the one that began last among those covering it."""
    spans = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in spans]

    def label(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            name, _, end = spans[i]
            if end >= t:
                return ("op, other host work" if name == OP
                        else name[len(SPAN):])
            i -= 1
        return "between ops"
    return label


def reduce(device, host, w0: float, w1: float) -> dict:
    """device: (name, start, end, is_copy) of every device operation;
    host: (name, start, end) of the labelled host spans and ops; w0, w1:
    the profiled window.  Times in any one unit; seconds out when the
    unit is seconds.  Returns the busy time (the union of all device
    operations), the kernel time (the sum of kernel durations, copies
    and memsets left out), the window, and the breakdown: device
    operations by summed time, and idle time by the host span it fell
    in, at most 10 of each."""
    clipped = [(n, max(s, w0), min(e, w1), c) for n, s, e, c in device
               if e > w0 and s < w1]
    busy_iv = union([(s, e) for _, s, e, _ in clipped])
    by_op = collections.Counter()
    for n, s, e, _ in clipped:
        by_op[n] += e - s
    idle = collections.Counter()
    label = host_labels(host)
    for s, e in gaps(busy_iv, w0, w1):
        idle[label((s + e) / 2)] += e - s
    return {
        "busy": sum(e - s for s, e in busy_iv),
        "kernel": sum(e - s for _, s, e, c in clipped if not c),
        "window": w1 - w0,
        "device_ops": [[n, t] for n, t in by_op.most_common(10)],
        "idle_gaps": [[n, t] for n, t in idle.most_common(10)],
    }


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def short_name(name: str) -> str:
    """A device operation's name without the namespaces that every
    PyTorch kernel carries, at most 160 characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(noise, "")
    return name[:160]


def read_profile(prof) -> dict:
    """reduce() over a torch.profiler run whose ops were marked by
    labelled() and OP inside one WINDOW range, in seconds.  Reads the
    profiler's raw events: building its FunctionEvent tree takes minutes
    on the hundreds of thousands of launches of an encode."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns()
        t = s + e.duration_ns()
        on_card = e.device_type() == DeviceType.CUDA
        if name.startswith("codecbench."):
            # the card's copy of a host label is an annotation, no work
            if on_card:
                continue
            if name == WINDOW:
                window = (s, t)
            else:
                host.append((name, s, t))
        elif on_card:
            device.append((short_name(name), s, t, is_copy(name)))
    if window is None:
        raise RuntimeError("the profiled window left no trace")
    # integer ns from the window's start, then seconds: absolute ns in a
    # float keep only ~0.2 us
    w0 = window[0]
    return reduce([(n, (s - w0) * 1e-9, (t - w0) * 1e-9, c)
                   for n, s, t, c in device],
                  [(n, (s - w0) * 1e-9, (t - w0) * 1e-9) for n, s, t in host],
                  0.0, (window[1] - w0) * 1e-9)
