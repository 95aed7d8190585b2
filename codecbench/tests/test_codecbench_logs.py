"""The logs-l3 configuration: the access-log generator, the level check
of its driver and the readers of level 3's search spans, on the CPU at a
small size."""
import collections
import datetime
import re
import types

import numpy as np
import pytest

from codecbench import harness, program
from codecbench.data import access_logs

# Apache httpd's Combined Log Format, as its documentation gives it
CLF = re.compile(rb'^(\d{1,3}(?:\.\d{1,3}){3}) - - \[(\d\d/[A-Z][a-z]{2}/'
                 rb'\d{4}:\d\d:\d\d:\d\d \+0000)\] "(GET|POST) (/\S*) '
                 rb'HTTP/1\.1" (\d{3}) (\d+|-) "([^"]*)" "([^"]*)"$')
SEED = 2 ** 31 + 4099
# two chunks of two blocks, the second partial: seconds a level-3 encode
SMALL = {"chunk_bytes": 40000, "pool": 2}


@pytest.fixture(scope="module")
def chunk():
    return access_logs.make_pool(SEED, 1, 1 << 20)[0]


def test_the_pool_is_made_from_the_seed():
    a = access_logs.make_pool(SEED, 2, 50000)
    assert a == access_logs.make_pool(SEED, 2, 50000)
    assert [len(c) for c in a] == [50000, 50000] and a[0] != a[1]
    assert a[0] != access_logs.make_pool(SEED + 1, 1, 50000)[0]
    assert a[1] == access_logs.make_chunk(np.random.default_rng((SEED, 1)),
                                          50000)


def test_every_line_is_combined_log_format(chunk):
    lines = chunk.split(b"\n")[:-1]               # the last is cut
    assert len(lines) > 3000
    parsed = [CLF.match(line) for line in lines]
    assert all(parsed), next(l for l, m in zip(lines, parsed) if not m)
    assert 180 <= np.mean([len(line) + 1 for line in lines]) <= 300
    stamps = [datetime.datetime.strptime(m.group(2).decode(),
                                         "%d/%b/%Y:%H:%M:%S %z")
              for m in parsed]
    steps = {(b - a).total_seconds() for a, b in zip(stamps, stamps[1:])}
    assert steps <= {0, 1, 2}
    status = collections.Counter(m.group(5) for m in parsed)
    assert status.most_common(1)[0][0] == b"200"
    assert set(status) <= {b"200", b"304", b"301", b"404", b"500"}
    sizes = [int(m.group(6)) for m in parsed if m.group(6) != b"-"]
    assert 0 < min(sizes) and max(sizes) <= access_logs.MAX_SIZE
    agents = {m.group(8) for m in parsed}
    assert all(100 <= len(a) <= 140 for a in agents)


def test_popularity_is_skewed(chunk):
    lines = chunk.split(b"\n")[:-1]
    clients = collections.Counter(line.split(b" ", 1)[0] for line in lines)
    top = sum(c for _, c in clients.most_common(access_logs.CLIENTS // 10))
    # Zipf 0.8 over 4,096: the top tenth draws ~54% of the lines
    assert top / len(lines) > 0.4
    assert clients.most_common(1)[0][1] > 20 * len(lines) / 4096
    p = access_logs.zipf_p(4)
    assert p == pytest.approx(np.arange(1, 5) ** -0.8 / sum(
        np.arange(1, 5) ** -0.8))


@pytest.fixture(scope="module")
def level3_run():
    run = harness.Run(harness.load_cell("logs-l3.write"), SEED, "cpu",
                      **SMALL)
    yield run
    run.close()


def test_the_level_check_passes_level3_streams(level3_run):
    ops = level3_run.loop(0) + level3_run.loop(0, first=1)
    checks = level3_run.judge(ops)
    assert harness.verdict(checks, ops), checks
    assert checks["streams_over_level"] == (0, 0)
    ratios = level3_run.driver.ratios
    assert len(ratios) == 2
    assert all(1 <= r <= level3_run.driver.ceiling for r in ratios)
    detail = level3_run.driver.detail(level3_run.inputs, ops)
    assert detail["level_check"]["ratios"] == ratios


def test_the_level_check_fails_level2_streams_of_the_same_chunks(
        level3_run):
    cell = harness.load_cell("logs-l3.write")
    cell.config = dict(cell.config, level=2)
    run = harness.Run(cell, SEED, "cpu", **SMALL)
    assert run.chunks == level3_run.chunks
    ops = run.loop(0) + run.loop(0, first=1)
    checks = run.judge(ops)
    assert not harness.verdict(checks, ops)
    assert checks["streams_over_level"] == (2, 0)
    assert checks["ops_wrong"] == (0, 0)           # right, but too large
    assert all(r > run.driver.ceiling for r in run.driver.ratios)
    run.close()


@pytest.mark.parametrize("fault", harness.FAULTS)
def test_each_fault_is_not_correct(level3_run, fault):
    ops = level3_run.loop(0, fault=fault) + level3_run.loop(0, first=1)
    checks = level3_run.judge(ops)
    assert not harness.verdict(checks, ops)
    assert checks["ops_wrong"][0] == 1, checks


def test_the_blocks_checked_are_drawn_from_the_chunk(level3_run):
    d = level3_run.driver
    a, b = level3_run.chunks
    assert list(d.picks(a)) == list(d.picks(a))
    assert len(d.picks(a)) == 2                    # both of its blocks
    d.sample = 3
    try:
        big = access_logs.make_pool(SEED, 1, 40 * 32768)[0]
        got = d.picks(big)
        assert len(got) == 3 and len(set(got)) == 3 and max(got) < 40
    finally:
        d.sample = harness.load_cell("logs-l3.write").config[
            "level_check_blocks"]


READERS = ["lz77_chain_self_ms_per_MiB", "lz77_tiers_self_ms_per_MiB",
           "lz77_pairs_per_ns"]


def _ctx(n_ops, chunk=2 ** 20):
    run = types.SimpleNamespace(chunks=[b"x" * chunk])
    ops = [harness.Op(0, float(k), k + 0.5, b"", None)
           for k in range(n_ops)]
    return harness.Context(run, ops, 1.0)


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_without_a_recorder(monkeypatch, name):
    monkeypatch.setattr(program, "recorder", lambda: None)
    assert harness.reader(name).read(_ctx(3)) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_where_the_program_has_no_such_span(
        monkeypatch, name):
    """The parent commit's program: a recorder, no search spans."""
    snap = {"ops": 2, "counts": {"copy.h2d": 4},
            "spans": {"lz77.find_matches": {"n": 2, "total_s": 1.0,
                                            "self_s": 1.0}}}
    monkeypatch.setattr(program, "window", lambda: snap)
    assert harness.reader(name).read(_ctx(3)) is None


def test_readers_read_the_search_spans_and_pairs(monkeypatch):
    snap = {"ops": 2, "counts": {"lz77.pairs": 6 * 10 ** 9},
            "spans": {
                "lz77.find_matches": {"n": 2, "total_s": 1.0, "self_s": .1},
                "lz77.chain": {"n": 2, "total_s": .4, "self_s": .4},
                "lz77.tier": {"n": 4, "total_s": .6, "self_s": .2}}}
    monkeypatch.setattr(program, "window", lambda: snap)
    ctx = _ctx(5, chunk=2 * 2 ** 20)               # 2 MiB an op
    read = {n: harness.reader(n).read(ctx) for n in READERS}
    # 0.4 s over 2 ops of 2 MiB: 100 ms per MiB; 0.2 s: 50
    assert read["lz77_chain_self_ms_per_MiB"] == pytest.approx(100)
    assert read["lz77_tiers_self_ms_per_MiB"] == pytest.approx(50)
    # 6e9 pairs over 0.6 s of chain and tier self time
    assert read["lz77_pairs_per_ns"] == pytest.approx(10)
