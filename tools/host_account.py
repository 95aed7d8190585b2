"""Where the host's time goes in each program span of a benchmark cell's
ops, on the card: per op, each span's self time, the part of it the
program held the host blocked on the card (the recorder's wait_s), the
part the recorder's own synchronisations took (sync_s) and the rest,
host work, recorded as a traced window records them (synchronised
spans); and the op's median latency with the recorder off and on, in
alternating rounds.  With --sync-debug N, every synchronising CUDA call
torch reports in N more ops (torch.cuda.set_sync_debug_mode("warn")), by
the innermost program span open and the innermost line of the port that
made it.  The outputs are held as the benchmark holds them (one in
eight, drawn from the seed).  Needs a card; prints one JSON line.

    python3 tools/host_account.py --workload <cell> [--seed N] [--ops N]
        [--sync-debug N]

Run from a copy of an earlier commit (the script copied into its
tools/), it reads that commit's port and benchmark; a recorder that
keeps no wait_s or sync_s gives null for them.
"""
import argparse
import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings


def _quartiles(xs):
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return {"n": len(xs), "q1": q1, "median": q2, "q3": q3}


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def _idle_sync_us(n=200):
    """A synchronise with nothing enqueued, median us."""
    import torch

    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        torch.cuda.synchronize()
        ts.append(1e6 * (time.perf_counter() - t))
    return statistics.median(ts)


def _sync_sites(run, metrics, first, n, root):
    """Run n ops under the warning sync-debug mode, spans recorded without
    synchronising; count each reported synchronisation by (innermost open
    span, innermost port line, its source)."""
    import torch

    port = os.path.join(root, "deflate_tpu_torch") + os.sep
    sites = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()[:-1]
                  if f.filename.startswith(port)]
        if frames:
            f = frames[-1]
            where = f"{os.path.relpath(f.filename, root)}:{f.lineno}"
            src = (f.line or "").strip()
            # through the recorder's own helpers: name their caller too
            if f.filename.endswith(os.path.join("utils", "metrics.py")) \
                    and len(frames) > 1:
                c = frames[-2]
                where += (f" <- {os.path.relpath(c.filename, root)}:"
                          f"{c.lineno}")
        else:
            where, src = "outside the port", str(message)[:80]
        span = metrics._stack[-1].name if metrics._stack else "-"
        sites[(span, where, src)] += 1

    metrics.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with metrics.recording(sync=False):
                for k in range(n):
                    run.op(first + k, hold=run.hold(first + k))
                torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    metrics.reset()
    return [{"span": s, "site": w, "source": src, "per_op": c / n}
            for (s, w, src), c in sorted(sites.items())]


def main() -> int:
    ap = argparse.ArgumentParser(prog="host_account")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 2803)
    ap.add_argument("--ops", type=int, default=16,
                    help="ops a round, recorded or not")
    ap.add_argument("--sync-debug", type=int, default=0)
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)

    import torch

    from codecbench import harness
    from deflate_tpu_torch.utils import metrics

    if not torch.cuda.is_available():
        print("host_account: needs a card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    run = harness.Run(harness.load_cell(args.workload), args.seed, dev)
    try:
        run.warm()
        torch.cuda.synchronize()
        metrics.stop()
        metrics.reset()
        lat = {"untraced": [], "traced": []}
        k = 0
        recorded = 0
        for _ in range(2):
            for traced in (False, True):
                with (metrics.recording(sync=True) if traced
                      else contextlib.nullcontext()):
                    for _ in range(args.ops):
                        o = run.op(k, hold=run.hold(k))
                        if o.note is not None:
                            raise RuntimeError(f"op {k}: {o.note}")
                        lat["traced" if traced else "untraced"].append(
                            1e3 * (o.t1 - o.t0))
                        k += 1
                        recorded += traced
        snap = metrics.snapshot()
        assert snap["ops"] == recorded, (snap["ops"], recorded)
        spans = {}
        for name, v in sorted(snap["spans"].items(),
                              key=lambda x: -x[1]["self_s"]):
            ms = {f: (1e3 * v[f + "_s"] / recorded if f + "_s" in v
                      else None) for f in ("self", "wait", "sync")}
            spans[name] = {"n": v["n"] / recorded,
                           **{f + "_ms": x for f, x in ms.items()},
                           "host_ms": (None if ms["wait"] is None else
                                       ms["self"] - ms["wait"]
                                       - ms["sync"])}

        def total(f):
            got = [s[f] for s in spans.values()]
            return None if None in got else sum(got)

        out = {"cell": args.workload, "seed": args.seed, "card": _card(),
               "tree": root, "recorded_ops": recorded,
               "op_ms": {k: _quartiles(v) for k, v in lat.items()},
               "per_op": {f: total(f) for f in
                          ("self_ms", "wait_ms", "sync_ms", "host_ms")},
               "spans": spans, "idle_sync_us": _idle_sync_us()}
        if args.sync_debug:
            out["sync_sites"] = _sync_sites(run, metrics, k,
                                            args.sync_debug, root)
    finally:
        run.close()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
