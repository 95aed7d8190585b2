"""The logs-l3-range configuration: the time index and the windows of its
driver, the range reads judged against the chunk and the plain range
reference, the faults, a program that cannot read a range on a device,
and the readers of the range read's spans; on the CPU at a small size."""
import datetime
import re

import numpy as np
import pytest

from codecbench import harness, program
from codecbench.data import access_logs
from codecbench.reference import range as reference

CELL = "logs-l3-range.read"
SEED = 2 ** 31 + 2641
# two chunks of four blocks, the last partial, spanning ~6.5 minutes each:
# windows of 1 and 4 minutes in the cell's 3:1 mix
SMALL = {"chunk_bytes": 100_000, "pool": 2}
SHORT = {"range_windows_s": [60, 240]}
READERS = ["range_decode_self_ms_per_op.prep",
           "range_decode_self_ms_per_op.device",
           "range_decode_self_ms_per_op.transfer"]


def _cell(**config):
    cell = harness.load_cell(CELL)
    cell.config = dict(cell.config, **SHORT, **config)
    return cell


@pytest.fixture(scope="module")
def run():
    r = harness.Run(_cell(), SEED, "cpu", **SMALL)
    yield r
    r.close()


def _driver():
    return harness.load("drivers", "manifest_range")


def test_the_time_index_reads_every_whole_line():
    chunk = access_logs.make_pool(SEED, 1, 60_000)[0]
    seconds, starts = _driver().line_index(chunk)
    lines = chunk.split(b"\n")[:-1]               # the last is cut
    assert len(seconds) == len(lines) == len(starts) - 1
    for k in range(len(lines)):
        assert chunk[starts[k]:starts[k + 1]] == lines[k] + b"\n"
    for k in (0, 1, len(lines) // 2, len(lines) - 1):
        stamp = re.search(rb"\[([^]]+)\]", lines[k]).group(1).decode()
        when = datetime.datetime.strptime(stamp, "%d/%b/%Y:%H:%M:%S %z")
        assert seconds[k] == when.timestamp()
    assert (np.diff(seconds) >= 0).all()


def test_windows_are_whole_lines_of_their_length(run):
    mix = run.cell.config["range_windows_s"]
    for chunk, inp in zip(run.chunks, run.inputs):
        seconds, starts = _driver().line_index(chunk)
        first = np.searchsorted(starts, inp.lo)
        last = np.searchsorted(starts, inp.hi)
        assert (starts[first] == inp.lo).all()
        assert (starts[last] == inp.hi).all()
        assert (last > first).all()
        spread = seconds[last - 1] - seconds[first]
        assert (spread < max(mix)).all()
        short = spread < min(mix)
        assert 0.6 < short.mean() < 0.9           # 3:1, less the edges


def test_windows_repeat_for_a_seed_and_differ_for_another():
    cheap = _cell(level=2)                        # the windows alone
    runs = [harness.Run(cheap, s, "cpu", **SMALL)
            for s in (SEED, SEED, SEED + 1)]
    a, b, c = ([(i.lo, i.hi) for i in r.inputs] for r in runs)
    assert a == b and a != c
    for r in runs:
        r.close()


def test_the_run_is_correct_and_no_block_is_decoded_on_the_host(run):
    ops = run.loop(0) + run.loop(0, first=1) + run.loop(0, first=2)
    checks = run.judge(ops)
    assert harness.verdict(checks, ops), checks
    assert set(checks) == {"ops_lost", "ops_wrong", "ops_unlike_reference",
                           "manifests_wrong"}
    assert all(o.note is None for o in ops)
    assert run.driver.host_blocks == 0
    for o in ops:
        start, end, out = o.out
        stream, man = run.inputs[o.index].stream, run.inputs[o.index].man
        assert out == reference.decode_range(stream, man.blocks, start, end)
        assert o.size == end - start
        assert run.driver.io_bytes(run.inputs[o.index], o.out) > end - start
    detail = run.driver.detail(run.inputs, ops)["range"]
    assert detail["calls"] == sum(i.calls for i in run.inputs)
    assert detail["mean_blocks"] >= 1
    assert detail["mean_bytes_decoded"] >= detail["mean_bytes_returned"]
    assert detail["mean_stream_bytes"] < detail["mean_bytes_decoded"]


@pytest.mark.parametrize("fault", harness.FAULTS)
def test_each_fault_is_not_correct(run, fault):
    ops = run.loop(0, fault=fault) + run.loop(0, first=1)
    checks = run.judge(ops)
    assert not harness.verdict(checks, ops)
    assert checks["ops_wrong"][0] == 1, checks
    assert checks["ops_unlike_reference"][0] == 1, checks


def test_an_op_with_a_block_decoded_on_the_host_fails(run, monkeypatch):
    from deflate_tpu_torch.runtime import manifest

    real = manifest.decode_range

    def on_the_host(stream, man, start, end, device=None):
        return real(stream, man, start, end, None)    # every block on the host
    monkeypatch.setattr(manifest, "decode_range", on_the_host)
    op = run.op(0)
    assert op.note is not None and op.note.endswith("decoded on the host")
    assert run.judge([op])["ops_wrong"] == (0, 0)


def test_a_program_that_reads_ranges_on_the_host_alone_fails_in_prepare(
        monkeypatch):
    """The parent commit's decode_range(stream, man, start, end): the run
    stops before the first set-up encode."""
    from deflate_tpu_torch.runtime import manifest

    def decode_range(stream, man, start, end):
        raise AssertionError("never called")

    def no_encode(*a, **k):
        raise AssertionError("prepare encoded before it checked")
    monkeypatch.setattr(manifest, "decode_range", decode_range)
    monkeypatch.setattr(manifest, "compress_with_manifest", no_encode)
    with pytest.raises(RuntimeError, match="takes no device"):
        harness.Run(_cell(), SEED, "cpu", **SMALL)


def test_the_readers_read_a_recorded_window(run):
    m = program.recorder()
    m.stop()
    m.reset()
    try:
        with m.recording(sync=False):
            ops = run.loop(0) + run.loop(0, first=1)
        ctx = harness.Context(run, ops, 1.0)
        read = {n: harness.reader(n).read(ctx) for n in READERS}
        assert all(v > 0 for v in read.values()), read
        snap = program.window()
        assert snap["ops"] == len(ops)
        assert snap["counts"]["decode.path.wave"] == len(ops)
        assert snap["counts"]["decode.range_blocks"] >= len(ops)
        assert program.copies_per_op(ctx) == 0     # no copy on the CPU
    finally:
        m.stop()
        m.reset()


@pytest.mark.parametrize("name", READERS)
def test_the_readers_are_silent_without_a_range_read(monkeypatch, name):
    """A recorder whose window read no range (the parent commit's
    program), and no recorder."""
    ctx = harness.Context(None, [harness.Op(0, 0.0, 1.0, b"", None)], 1.0)
    monkeypatch.setattr(program, "window", lambda: {
        "ops": 1, "counts": {},
        "spans": {"decode": {"n": 1, "total_s": 1.0, "self_s": .5},
                  "decode.headers": {"n": 1, "total_s": .5, "self_s": .5}}})
    assert harness.reader(name).read(ctx) is None
    monkeypatch.setattr(program, "window", lambda: None)
    assert harness.reader(name).read(ctx) is None


def test_the_readers_split_the_self_time_per_op(monkeypatch):
    spans = {"decode": .1, "decode.range_plan": .2, "decode.headers": .3,
             "decode.windows": .4, "decode.to_device": .5,
             "decode.stages": .6, "wave.resolve_litval": .7,
             "wave.merge_match_runs": .8, "decode.fill": .9,
             "decode.to_host": 1.0}
    monkeypatch.setattr(program, "window", lambda: {
        "ops": 2, "counts": {},
        "spans": {k: {"n": 2, "total_s": 9.0, "self_s": v}
                  for k, v in spans.items()}})
    ctx = harness.Context(None, [], 1.0)
    read = {n.split(".")[1]: harness.reader(n).read(ctx) for n in READERS}
    assert read == pytest.approx({"prep": 450, "device": 1500,
                                  "transfer": 750})
