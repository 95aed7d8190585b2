"""The skeleton walk alone on the host: the process's CPU affinity, then
dt_skeleton against the walk in pieces (native.skeleton, and
native._skeleton at each thread count up to the affinity's) on the
benchmark's 8 MiB zlib-6 chunk of the mixed corpus (chunk 0 of seed 0),
every plan held to dt_skeleton's.  Needs no card; prints one JSON line.

    python3 tools/skeleton_split.py [--tree DIR] [--reps N]

--tree DIR also times DIR's native.skeleton (an unpacked earlier
commit) on the same stream, in a subprocess run from DIR."""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from codecbench.data.mixed_corpus import make_corpus  # noqa: E402

CHILD = """
import json, sys, time, zlib
import numpy as np
from codecbench.data.mixed_corpus import make_corpus
from deflate_tpu_torch import native as N
raw = zlib.compress(make_corpus(np.random.default_rng((0, 0)), 8 << 20),
                    6)[2:-4]
N.skeleton(raw)
ms = []
for _ in range(int(sys.argv[1])):
    t = time.perf_counter()
    N.skeleton(raw)
    ms.append(1e3 * (time.perf_counter() - t))
print(json.dumps(ms))
"""


def _times(fn, reps):
    fn()
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        r = fn()
        out.append(1e3 * (time.perf_counter() - t))
    return out, r


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree")
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args()
    from deflate_tpu_torch import native as N

    cores = sorted(os.sched_getaffinity(0))
    raw = zlib.compress(make_corpus(np.random.default_rng((0, 0)), 8 << 20),
                        6)[2:-4]
    seq_ms, (want, _) = _times(lambda: N._skeleton(raw, 1, 0), a.reps)
    res = {"affinity": cores, "cpu_count": os.cpu_count(),
           "stream_bytes": len(raw), "vbs": len(want["out_len"]),
           "dt_skeleton_ms": seq_ms}

    def same(plan):
        return all(np.array_equal(plan[k], want[k]) for k in want
                   if k != "total_out") and (plan["total_out"]
                                             == want["total_out"])

    ms, plan = _times(lambda: N.skeleton(raw), a.reps)
    res["skeleton_ms"] = ms
    res["skeleton_same"] = same(plan)
    sweep = {}
    for t in sorted({1, 2, 4, 8, len(cores)} & set(range(1, len(cores) + 1))):
        piece = max(N.MIN_PIECE, -(-len(raw) // (N.PIECES_PER_THREAD * t)))
        ms, (plan, stats) = _times(lambda: N._skeleton(raw, t, piece),
                                   a.reps)
        sweep[t] = {"median_ms": statistics.median(ms), "min_ms": min(ms),
                    "piece_bytes": piece, "stats": stats,
                    "same": same(plan)}
    res["sweep"] = sweep
    if a.tree:
        r = subprocess.run([sys.executable, "-c", CHILD, str(a.reps)],
                           cwd=a.tree, capture_output=True, text=True,
                           env={**os.environ, "PYTHONPATH": a.tree})
        res["tree_skeleton_ms"] = (json.loads(r.stdout.splitlines()[-1])
                                   if r.returncode == 0 else r.stderr[-2000:])
    for k in ("dt_skeleton_ms", "skeleton_ms", "tree_skeleton_ms"):
        if isinstance(res.get(k), list):
            res[k.replace("_ms", "_median_ms")] = statistics.median(res[k])
    print(json.dumps(res))


if __name__ == "__main__":
    main()
