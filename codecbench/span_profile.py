"""Launch calls and idle time of a cell's profiled ops, by the program's
own spans.

    python3 -m codecbench.span_profile --workload <name> --seed <n> \
        [--ops 4] [--out <file>]

Sets the cell up as run.py does (pool, entry driver, warm-up calls), then
profiles --ops calls, each marked as run.py marks them, with the
program's recorder on and not synchronising.  From the profiler's events
it counts the CUDA runtime's launch and copy calls on the host
(LAUNCHES, COPIES) by the innermost program span that covers each,
against the kernels and copies the card ran; names each idle stretch of
the card by the innermost program span that covers it (trace.reduce over
the program's spans); and prints the program's own counts beside them.  Prints one
JSON line, and writes it to --out too.  Needs a card.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys

# the CUDA runtime and driver calls that launch a kernel, and that copy
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")
COPIES = ("cudaMemcpy", "cudaMemcpyAsync", "cuMemcpyAsync", "cuMemcpy")


def launch_counts(launch_times, host) -> dict:
    """{innermost host label: launch calls}: host holds (name, start,
    end) as trace.reduce takes them (trace.OP, trace.SPAN + span name)."""
    from codecbench import trace

    label = trace.host_labels(host)
    return dict(collections.Counter(label(t) for t in launch_times))


def host_spans(ops, program, prefix: str) -> list:
    """trace.reduce's host list: the harness's ops and the program's
    spans (names with `prefix`), so that the finest covering program span
    labels a stretch, and an op with none "op, other host work"."""
    from codecbench import trace

    return ([(trace.OP, s, e) for s, e in ops]
            + [(trace.SPAN + n[len(prefix):], s, e) for n, s, e in program])


def reduce_events(events, prefix: str) -> dict:
    """events: (name, start, end, on_card) in seconds from the window's
    start, the window itself named trace.WINDOW.  Returns the launch
    calls by span, the kernels and copies the card ran, and the idle
    breakdown by program span."""
    from codecbench import trace

    window, ops, program, launches, copies, device = (None, [], [], [],
                                                      [], [])
    for name, s, e, on_card in events:
        if on_card:
            if not name.startswith(("codecbench.", prefix)):
                device.append((trace.short_name(name), s, e,
                               trace.is_copy(name)))
        elif name == trace.WINDOW:
            window = (s, e)
        elif name == trace.OP:
            ops.append((s, e))
        elif name.startswith(prefix):
            program.append((name, s, e))
        elif name in LAUNCHES:
            launches.append(s)
        elif name in COPIES:
            copies.append(s)
    if window is None:
        raise RuntimeError("the profiled window left no trace")
    host = host_spans(ops, program, prefix)
    red = trace.reduce(device, host, *window)
    idle = dict(red["idle_gaps"])
    kernels = [d for d in device if not d[3]]
    on_card = [d for d in device if d[0].startswith(("Memcpy", "memcpy"))]

    def by_span(times):
        got = launch_counts(times, host)
        return dict(sorted(got.items(), key=lambda kv: -kv[1]))
    return {"launch_calls": len(launches), "kernels": len(kernels),
            "copies_on_card": len(on_card), "copy_calls": len(copies),
            "copies_on_card_by_kind": dict(collections.Counter(
                d[0][:11] for d in on_card)),
            "launch_calls_by_span": by_span(launches),
            "copy_calls_by_span": by_span(copies),
            "idle_s": red["window"] - red["busy"],
            "idle_by_span_s": idle, "window_s": red["window"],
            "busy_s": red["busy"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="codecbench.span_profile")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--ops", type=int, default=4)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from codecbench import harness, program, trace

    m = program.recorder()
    if m is None or not torch.cuda.is_available():
        print("codecbench.span_profile: needs a card and the program's "
              "recorder", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    run = harness.Run(cell, args.seed, dev)
    run.warm()
    torch.cuda.synchronize()
    m.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with m.recording(sync=False):
            with record_function(trace.WINDOW):
                for k in range(args.ops):
                    with record_function(trace.OP):
                        run.op(k, hold=False)
                torch.cuda.synchronize()
    snap = m.snapshot(profiled=True)
    run.close()
    raw = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
            e.device_type() == DeviceType.CUDA)
           for e in prof.profiler.kineto_results.events()]
    w0 = next(s for n, s, _, c in raw if n == trace.WINDOW and not c)
    out = reduce_events([(n, (s - w0) * 1e-9, (e - w0) * 1e-9, c)
                         for n, s, e, c in raw], m.SPAN_PREFIX)
    out.update({"cell": cell.name, "seed": args.seed, "ops": args.ops,
                "counts": snap["counts"],
                "self_s": {k: v["self_s"] for k, v in snap["spans"].items()},
                "runtime_calls": dict(collections.Counter(
                    n for n, _, _, c in raw
                    if not c and n.startswith(("cuda", "cu")))
                    .most_common(12))})
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
