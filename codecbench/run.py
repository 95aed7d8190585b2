"""Run one cell of the benchmark once, on one NVIDIA card.

    python3 -m codecbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the CUDA context, the kernels' build or load, the pool
of chunks made from the seed, the entry driver's set-up, the cell's
``warmup_ops`` warm-up calls), then a closed loop of back-to-back calls
to the cell's entry for --seconds, then the judgement of every output.
--trace 0 reports the cell's end-to-end metrics.  --trace 1 installs
synchronised spans for the window and reports the per-layer metrics,
then profiles a fixed number of further calls (the cell's
``profile_ops``) for the device's busy time, kernel time and the
breakdown.

The last line of standard output is the result; the line before it holds
the details (latencies and their counts, the ratio, set-up phases, the
card's power limit, what the entry driver counted).  The checks, each
with its limit, are also the last lines of standard error.  Without a
card the run fails and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "deflate_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="codecbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from codecbench import harness, trace
    from codecbench.yardstick import p95

    bench = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        print(f"codecbench: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < entry["chips"]):
        print(f"codecbench: {args.workload} needs {entry['chips']} CUDA "
              "card(s); none here, and it never runs on the CPU",
              file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, bench)
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    phases = {"imports_and_context_s": time.perf_counter() - T0}

    t = time.perf_counter()
    run = harness.Run(cell, args.seed, dev)
    torch.cuda.synchronize()
    phases["pool_and_prepare_s"] = time.perf_counter() - t
    t = time.perf_counter()
    warm = run.warm()
    torch.cuda.synchronize()
    phases["warmup_s"] = time.perf_counter() - t
    phases["warmup_ms"] = [1e3 * (o.t1 - o.t0) for o in warm]

    spans, totals = [], {}
    if args.trace:
        for m in cell.per_layer:
            for s in getattr(harness.reader(m["name"]), "SPANS", []):
                if tuple(s) not in spans:
                    spans.append(tuple(s))
    timers = trace.timed(spans, totals, torch.cuda.synchronize)
    host0 = harness.host_counters()
    try:
        ops = run.loop(args.seconds)
    finally:
        timers.undo()
    host = harness.host_delta(host0, harness.host_counters())

    profiled, red = [], None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        labels = trace.labelled(spans)
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function(trace.WINDOW):
                    for k in range(cell.spec["profile_ops"]):
                        with record_function(trace.OP):
                            profiled.append(run.op(len(ops) + k))
                    torch.cuda.synchronize()
        finally:
            labels.undo()
        red = trace.read_profile(prof)

    memory_peak = torch.cuda.max_memory_allocated(dev)
    kind = torch.cuda.get_device_name(0)
    run.close()

    every = ops + profiled
    checks = run.judge(every)
    ctx = harness.Context(run, ops, ops[0].t0 - T0, totals, red,
                          sum(run.driver.io_bytes(run.inputs[o.index], o.out)
                              for o in profiled if o.out is not None),
                          kind)
    lat = [1e3 * (o.t1 - o.t0) for o in ops]
    driver_detail = run.driver.detail(run.inputs, ops)
    driver_detail["ratio"] = driver_detail["stream_bytes"] / ctx.work_bytes
    detail = {
        "cell": cell.name, "seed": args.seed, "seconds": args.seconds,
        "trace": args.trace, "ops": len(ops), "window_s": ctx.window_s,
        "latency_ms": {"n": len(lat), "median": sorted(lat)[len(lat) // 2],
                       "p95": p95(lat), "min": min(lat), "max": max(lat),
                       "samples_beyond_p95": sum(x > p95(lat) for x in lat)},
        "outputs_judged": sum(o.out is not None for o in every),
        "failed_notes": dict(collections.Counter(
            o.note for o in every if o.note)),
        "setup": phases, "power": power_limit(), "host_in_window": host,
        "driver": driver_detail,
        "chunk_bytes": run.chunk_bytes, "pool": len(run.chunks),
        "spans_s": totals,
    }
    if red is not None:
        detail["profile"] = {"ops": len(profiled), "busy_s": red["busy"],
                             "kernel_s": red["kernel"],
                             "window_s": red["window"],
                             "io_bytes": ctx.io_bytes}
    detail["judge_s"] = time.perf_counter() - ops[-1].t1

    section = cell.per_layer if args.trace else cell.end_to_end
    result = {
        "correct": harness.verdict(checks, every),
        "attempted": len(every),
        "failed": sum(o.note is not None for o in every),
        "metrics": harness.read_metrics(section, ctx),
        "device": {"platform": "gpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": memory_peak},
    }
    if red is not None:
        result["device"]["busy_s"] = red["busy"]
        result["device"]["window_s"] = red["window"]
        result["breakdown"] = {"device_ops": red["device_ops"],
                               "idle_gaps": red["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return emit(detail, result)


def emit(detail: dict, result: dict) -> int:
    """Print the details, the result and the checks, once everything of
    the run has been done: the judgement and every metric reader.  If
    anything loaded JAX or the JAX package in this process, print no
    result and fail."""
    found = forbidden_modules()
    if found:
        print(f"codecbench: the run loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps({"detail": detail}))
    print(json.dumps(result), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0

if __name__ == "__main__":
    sys.exit(main())
