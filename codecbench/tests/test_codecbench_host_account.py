"""The readers of how long the program held the host blocked on the card
in its spans (wait_s), per MiB in the encode and decode cells and per op
in the range cell (codecbench/host_account.py)."""
import json
import os
import time
import types

import pytest

from codecbench import harness, program
from helpers import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
ENCODE = ["archive-l2.write", "logs-l3.write"]
DECODE = ["bare-deflate.read", "archive-l2-hintless.read"]
RANGE = ["logs-l3-range.read"]
CELLS = {"card_wait_ms_per_MiB.encode": ENCODE,
         "card_wait_ms_per_MiB.decode": DECODE,
         "card_wait_ms_per_op.range": RANGE}
NAMES = list(CELLS)


def _ctx(n_ops, chunk=2 ** 20):
    run = types.SimpleNamespace(chunks=[b"x" * chunk])
    ops = [harness.Op(0, float(k), k + 0.5, b"", None)
           for k in range(n_ops)]
    return harness.Context(run, ops, 1.0)


def _read(name, ctx):
    return harness.reader(name).read(ctx)


def _span(self_s, wait_s=None, sync_s=0.0):
    d = {"n": 2, "total_s": self_s, "self_s": self_s}
    if wait_s is not None:
        d.update(wait_s=wait_s, sync_s=sync_s)
    return d


# two ops of a range read: wait 0.003 + 0.009 + 0.002 s a snapshot; the
# recorder's own synchronisations (sync_s) are not read
SNAP = {"ops": 2, "counts": {"copy.d2h": 4},
        "spans": {"decode": _span(0.02, 0.003, 0.5),
                  "decode.range_plan": _span(0.004, 0.0),
                  "decode.stages": _span(0.008, 0.009, 0.25),
                  "decode.to_host": _span(0.003, 0.002)}}


def test_the_three_are_in_the_benchmark_for_exactly_their_cells():
    got = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in CELLS}
    assert set(got) == set(CELLS)
    for name, cells in CELLS.items():
        assert got[name]["workloads"] == cells
        for w in BENCH["workloads"]:
            listed = [m["name"] for m in
                      harness.load_cell(w["name"], BENCH).per_layer]
            assert (name in listed) == (w["name"] in cells), (name, w)
    assert {got[n]["source"] for n in NAMES} == {"program_span"}


@pytest.mark.parametrize("name", NAMES)
def test_each_is_read_by_a_reader_of_its_own(name):
    path = harness.reader(name).__file__
    assert os.path.dirname(path) == os.path.join(harness.HERE, "metrics")
    assert os.path.basename(path).startswith(name.split(".")[0])
    assert callable(harness.reader(name).read)


@pytest.mark.parametrize("name", NAMES)
def test_silent_without_the_recorder_or_an_op(name, monkeypatch):
    monkeypatch.setattr(program, "recorder", lambda: None)
    assert _read(name, _ctx(3)) is None
    monkeypatch.undo()
    monkeypatch.setattr(program, "window", lambda: None)
    assert _read(name, _ctx(3)) is None


@pytest.mark.parametrize("name", NAMES)
def test_silent_where_the_recorder_keeps_no_host_fields(name, monkeypatch):
    """An older program's snapshot: times alone."""
    old = {"ops": 2, "counts": {},
           "spans": {k: _span(v["self_s"]) for k, v in SNAP["spans"].items()}}
    monkeypatch.setattr(program, "window", lambda: old)
    assert _read(name, _ctx(3)) is None


def test_the_range_reader_is_silent_where_no_range_was_read(monkeypatch):
    snap = dict(SNAP, spans={k: v for k, v in SNAP["spans"].items()
                             if k != "decode.range_plan"})
    monkeypatch.setattr(program, "window", lambda: snap)
    assert _read("card_wait_ms_per_op.range", _ctx(3)) is None


def test_per_mib_and_per_op_arithmetic(monkeypatch):
    monkeypatch.setattr(program, "window", lambda: SNAP)
    ctx = _ctx(5, chunk=2 * 2 ** 20)        # 2 MiB an op
    # 0.014 s of wait over 2 ops: 7 ms an op, 3.5 ms per MiB
    assert _read("card_wait_ms_per_op.range", ctx) == pytest.approx(7)
    assert _read("card_wait_ms_per_MiB.encode", ctx) == pytest.approx(3.5)
    assert _read("card_wait_ms_per_MiB.decode", ctx) == pytest.approx(3.5)


def test_on_the_program_s_recorder(monkeypatch):
    """The real recorder, driven by hand on the CPU, with a stand-in for
    its synchronisation that sleeps 2 ms: a range read's plan span makes
    the range reader speak, and the recorder's own waits (sync_s) are
    not read as the program's."""
    m = program.recorder()
    m.stop()
    m.reset()
    try:
        with m.recording(sync=False):
            monkeypatch.setattr(m, "_sync", lambda: time.sleep(0.002))
            for _ in range(2):
                with m.span("decode"):
                    with m.span("decode.range_plan"):
                        pass
        sp = m.snapshot()["spans"]
        assert sp["decode.range_plan"]["sync_s"] >= 0.004
        ctx = _ctx(2, chunk=2 ** 20)
        assert _read("card_wait_ms_per_op.range", ctx) == 0
        assert _read("card_wait_ms_per_MiB.decode", ctx) == 0
    finally:
        m.stop()
        m.reset()
