"""The benchmark's harness: finds a cell's pieces by name, builds its
inputs from a seed, runs its closed loop and reads its metrics.

A cell is ``workloads/<name>.json``.  It names a configuration
(``configs/<config>.json``, whose ``generator`` names
``data/<generator>.py``) and an entry driver (``drivers/<driver>.py``).
Which metrics a cell reports is read from ``BENCHMARK.json``: every
metric whose ``workloads`` list holds the cell, or that has no such list.
Each metric is read by ``metrics/<name>.py``, or, where there is none, by
the reader of its quantity, ``metrics/<part of the name before the first
dot>.py``: ``device_idle_pct.encode`` and ``device_idle_pct.decode`` share
``device_idle_pct.py``.  So a new configuration, traffic mix, driver or
metric is a new file, or a new split of a quantity no file at all, plus
new entries in ``BENCHMARK.json``; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import resource
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# faults planted in what an entry returns, each of which must make a run
# not correct: the entry returns its input ("unchanged"), covers half of
# its chunk ("half"), or has one byte of its output inverted ("flip")
FAULTS = ("unchanged", "half", "flip")
# the share of the window's ops whose output is held for the judgement,
# drawn from the seed.  A caller drops each output; holding every one
# makes each call fault in fresh pages for its output (~3 ms for 8 MiB),
# which a reader's window would pay and a user's would not.
HELD_SHARE = 1 / 8
HOLD_STREAM = 0x484F4C44


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def load(kind: str, name: str):
    """codecbench/<kind>/<name>.py as a module; a name may hold dots."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"codecbench: no {kind} named {name!r} "
                                f"({path})")
    mod = "codecbench_" + kind + "__" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str):
    """The module that reads metric `name`: metrics/<name>.py, else the
    reader of its quantity, metrics/<name up to its first dot>.py."""
    whole = os.path.join(HERE, "metrics", name + ".py")
    return load("metrics", name if os.path.isfile(whole)
                else name.split(".")[0])


def metrics_of(bench: dict, section: str, cell: str) -> list[dict]:
    """The entries of BENCHMARK.json's `section` that `cell` reports."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict                 # workloads/<name>.json
    config: dict               # configs/<config>.json
    end_to_end: list[dict]     # BENCHMARK.json entries this cell reports
    per_layer: list[dict]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    if bench is None:
        bench = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    spec = read_json(os.path.join(HERE, "workloads", name + ".json"))
    config = read_json(os.path.join(HERE, "configs", spec["config"] + ".json"))
    return Cell(name, spec, config, metrics_of(bench, "end_to_end", name),
                metrics_of(bench, "per_layer", name))


@dataclasses.dataclass
class Op:
    index: int                 # the pool chunk it worked on
    t0: float                  # host clock at the call and at its return
    t1: float
    out: object                # the entry's output; None when not held
    note: str | None           # why the op counts as failed, else None
    lost: bool = False         # the call raised: no answer
    size: int = 0              # bytes of the output it returned


class Run:
    """One cell set up on one device: the pool of chunks, the entry driver's
    inputs made from them, and the ops run so far."""

    def __init__(self, cell: Cell, seed: int, device, chunk_bytes=None,
                 pool=None):
        self.cell = cell
        self.chunk_bytes = chunk_bytes or cell.config["chunk_bytes"]
        gen = load("data", cell.config["generator"])
        self.chunks = gen.make_pool(seed, pool or cell.config["pool"],
                                    self.chunk_bytes)
        self.driver = load("drivers", cell.spec["driver"]).Driver(
            cell.config, device)
        self.inputs = self.driver.prepare(self.chunks)
        # a stream of its own: the pool's chunk i draws from (seed, i)
        self.rng = np.random.default_rng((seed, HOLD_STREAM))
        self.held = np.zeros(0, bool)

    def hold(self, n: int) -> bool:
        """Whether the n-th op of a window holds its output for the
        judgement: the first always, the others a HELD_SHARE drawn from
        the seed."""
        while n >= len(self.held):
            self.held = np.concatenate(
                [self.held, self.rng.random(4096) < HELD_SHARE])
        return n == 0 or bool(self.held[n])

    def op(self, k: int, fault: str | None = None, hold: bool = True) -> Op:
        """The k-th call of the closed loop, on pool chunk k mod pool;
        its output is kept when `hold`.  fault plants one of FAULTS in
        what the entry returns (the benchmark's own tests and controls;
        never in a measured run)."""
        i = k % len(self.chunks)
        inp = self.inputs[i]
        t0 = time.perf_counter()
        try:
            if fault is None:
                out, note = self.driver.call(inp)
            else:
                out, note = self.driver.faulty(fault, inp)
        except Exception as e:  # an op that never answers; judged lost
            return Op(i, t0, time.perf_counter(), None,
                      f"raised {type(e).__name__}: {e}", lost=True)
        t1 = time.perf_counter()
        return Op(i, t0, t1, out if hold else None, note,
                  size=self.driver.out_bytes(out))

    def warm(self) -> list[Op]:
        """The cell's warm-up calls, before any timed one: the first
        builds or loads the kernels and fills the allocator's cache; every
        chunk has the same shape."""
        return [self.op(k) for k in range(self.cell.spec["warmup_ops"])]

    def loop(self, seconds: float, first: int = 0,
             fault: str | None = None) -> list[Op]:
        """Back-to-back calls, one caller, until `seconds` have passed
        since the first call began; the last call runs to its end."""
        ops = []
        k = first
        start = time.perf_counter()
        while True:
            ops.append(self.op(k, fault, self.hold(len(ops))))
            k += 1
            if ops[-1].t1 - start >= seconds:
                return ops

    def judge(self, ops: list[Op]) -> dict:
        """{check name: (value, limit)}: every op that raised, and the
        outputs held."""
        return self.driver.judge(self.chunks, ops)

    def close(self) -> None:
        self.driver.close()


@dataclasses.dataclass
class Context:
    """What a metric reader reads: the window's ops and, in a traced run,
    the synchronised spans and the profiled slice."""
    run: Run
    ops: list[Op]
    setup_s: float
    spans: dict = dataclasses.field(default_factory=dict)  # label -> s
    profile: dict | None = None     # trace.reduce's result
    io_bytes: int = 0               # bytes the profiled ops read and wrote
    device_kind: str = ""

    @property
    def window_s(self) -> float:
        return self.ops[-1].t1 - self.ops[0].t0

    @property
    def work_bytes(self) -> int:
        """Chunk bytes encoded or decoded by the window's ops."""
        return sum(len(self.run.chunks[o.index]) for o in self.ops)

    @property
    def mb_per_s(self) -> float:
        """work_bytes (10^6 bytes) over the window's seconds."""
        return self.work_bytes / self.window_s / 1e6

    @property
    def op_seconds(self) -> float:
        return sum(o.t1 - o.t0 for o in self.ops)

    def span_seconds(self, spans) -> float | None:
        """Summed seconds of these (module, function) spans; None when
        none of them ran."""
        got = [self.spans[f"{m}.{f}"] for m, f in spans
               if f"{m}.{f}" in self.spans]
        return sum(got) if got else None

    def ms_per_mib(self, seconds: float | None) -> float | None:
        if seconds is None:
            return None
        return 1e3 * seconds / (self.work_bytes / 2 ** 20)


def host_counters() -> dict:
    """This process's host clock, CPU seconds (all threads) and resident
    peak so far."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"wall_s": time.perf_counter(),
            "process_cpu_s": ru.ru_utime + ru.ru_stime,
            "max_rss_bytes": 1024 * ru.ru_maxrss}


def host_delta(before: dict, after: dict) -> dict:
    """host_counters() over a stretch of time, and the share of it that
    the process spent on a CPU; the resident peak as at its end."""
    wall = after["wall_s"] - before["wall_s"]
    cpu = after["process_cpu_s"] - before["process_cpu_s"]
    return {"wall_s": wall, "process_cpu_s": cpu,
            "cpu_share": cpu / wall if wall > 0 else None,
            "max_rss_bytes": after["max_rss_bytes"]}


def verdict(checks: dict, ops: list[Op]) -> bool:
    """`correct`: some op ran, and every check is within its limit."""
    return bool(ops) and all(v <= lim for v, lim in checks.values())


def read_metrics(entries: list[dict], ctx: Context) -> dict:
    """{name: {"value", "unit"}} of every entry whose reader finds
    something to read."""
    out = {}
    for m in entries:
        value = reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
