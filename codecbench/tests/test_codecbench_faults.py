"""`correct` comes out false with the timed path broken underneath, once
for each fault a one-card cell can have, and true without one.  The
harness's look for a card is skipped; the rest of a run is driven on the
CPU at a small size."""
import numpy as np
import pytest

from codecbench import harness
from helpers import CELLS, TINY


@pytest.fixture(scope="module", params=CELLS)
def run(request):
    r = harness.Run(harness.load_cell(request.param), 2 ** 31 + 9, "cpu",
                    **TINY)
    yield r
    r.close()


def test_sound_run_is_correct(run):
    ops = run.loop(0) + run.loop(0, first=1)
    checks = run.judge(ops)
    assert harness.verdict(checks, ops), checks
    assert all(o.note is None for o in ops)


@pytest.mark.parametrize("fault", harness.FAULTS)
def test_fault_is_not_correct(run, fault):
    ops = run.loop(0, fault=fault) + run.loop(0, first=1)
    checks = run.judge(ops)
    assert not harness.verdict(checks, ops)
    assert checks["ops_wrong"][0] == 1, checks


def test_an_op_that_raises_is_lost_and_failed(run, monkeypatch):
    def boom(inp):
        raise RuntimeError("kernel launch failed")
    monkeypatch.setattr(run.driver, "call", boom)
    op = run.op(0)
    assert op.lost and op.out is None
    assert op.note.startswith("raised RuntimeError")
    checks = run.judge([op])
    assert checks["ops_lost"][0] == 1 and not harness.verdict(checks, [op])


def test_an_op_the_wavefront_decoder_did_not_serve_is_failed(monkeypatch):
    run = harness.Run(harness.load_cell("bare-deflate.read"), 3, "cpu",
                      **TINY)
    chunk = run.chunks[0]

    def served_by(path):
        def entry(raw, device, force_device, stats):
            stats["device_path"] = path
            return chunk
        return entry
    for path, failed in (("wave", False), ("pallas_scalar", True),
                         ("speculative", True), ("native_host", True)):
        monkeypatch.setattr(run.driver, "entry", served_by(path))
        op = run.op(0)
        assert (op.note is not None) == failed, path
        assert op.note is None or path in op.note
    run.close()


def test_a_configuration_without_hints_is_written_and_read_without_them():
    for name in ("archive-l2.write", "archive-l2.read"):
        cell = harness.load_cell(name)
        cell.config = dict(cell.config, hints=False)
        run = harness.Run(cell, 11, "cpu", **TINY)
        ops = run.loop(0)
        checks = run.judge(ops)
        assert harness.verdict(checks, ops), (name, checks)
        if name == "archive-l2.write":
            assert ops[0].out[1].hints is None
            # a hinted manifest is wrong where the configuration has none
            cell.config = dict(cell.config, hints=True)
            hinted = harness.Run(cell, 11, "cpu", **TINY)
            ops[0].out = hinted.op(0).out
            assert run.judge(ops)["manifests_wrong"][0] == 1
            hinted.close()
        else:
            assert run.inputs[0][1].hints is None
        run.close()


def test_streams_judged_in_worker_processes_give_the_same_checks(
        monkeypatch):
    from codecbench import judge

    run = harness.Run(harness.load_cell("archive-l2.write"), 5, "cpu",
                      **TINY)
    ops = run.loop(0) + run.loop(0, first=1, fault="flip")
    alone = run.judge(ops)
    monkeypatch.setattr(judge, "PARALLEL_BYTES", 0)
    assert run.judge(ops) == alone
    assert alone["ops_wrong"][0] == 1 and alone["ops_lost"][0] == 0
    run.close()


def test_the_held_outputs_are_a_share_drawn_from_the_seed(run):
    drawn = [run.hold(n) for n in range(20000)]
    assert drawn[0] and 0.1 < sum(drawn) / len(drawn) < 0.15
    again = harness.Run.__new__(harness.Run)
    again.rng = np.random.default_rng((2 ** 31 + 9, harness.HOLD_STREAM))
    again.held = np.zeros(0, bool)
    assert [again.hold(n) for n in range(20000)] == drawn
    op = run.op(0, hold=False)
    assert op.out is None and not op.lost and op.size > 0
    assert run.judge([op]) == run.judge([])
