"""The span-and-counter recorder (deflate_tpu_torch/utils/metrics.py) and
the spans and counters at the layer boundaries of the encode and decode
paths.  No JAX: the CPU cases hold the port against itself with recording
off, and the one card case runs where JAX is absent:

    python -m pytest tests/test_torch_tracing.py --noconftest -p no:randomly -o addopts=""
"""
import os
import time
import types
import zlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import deflate_tpu_torch as D
from deflate_tpu_torch.runtime import manifest as M
from deflate_tpu_torch.utils import metrics
from torch_helpers import corpus, corrupt_block3, cuda_device  # noqa: F401

ENCODE = {"encode", "encode.split", "lz77.find_matches", "lz77.chain",
          "lz77.extend", "lz77.greedy_parse", "encode.trees",
          "encode.choose", "encode.emit", "encode.to_host"}
DECODE = {"decode", "decode.headers", "decode.windows", "decode.to_device",
          "decode.stages", "wave.resolve_litval", "wave.merge_match_runs",
          "decode.fill", "decode.to_host"}
HINTLESS = {"decode", "decode.windows", "decode.to_device",
            "decode.block_inflate", "decode.to_host"}


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts with recording off and nothing recorded."""
    metrics.stop()
    metrics.reset()
    yield
    metrics.stop()
    metrics.reset()


@pytest.fixture(scope="module")
def data():
    """Five 32 KiB blocks of the mixed corpus: five blocks so that
    block 3 can be corrupted."""
    return corpus(5)


def _profile_events(prof):
    return [e for e in prof.profiler.kineto_results.events()]


def test_recording_off_records_nothing():
    with metrics.span("x"):
        metrics.count("c")
    snap = metrics.snapshot()
    assert snap["spans"] == {} and snap["ops"] == 0
    assert snap["counts"] == {"c": 1}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.span("off_span"):
            torch.arange(10).sum()
    names = {e.name() for e in _profile_events(prof)}
    assert not any(n.endswith("off_span") for n in names)
    assert metrics.snapshot()["spans"] == {}


def test_to_host_of_a_host_tensor_is_no_copy():
    t = torch.arange(4)
    assert metrics.to_host(t) is t
    assert metrics.snapshot()["counts"] == {}


def test_nesting_parents_ops_and_self_time():
    with metrics.recording(sync=False):
        with metrics.span("op"):
            time.sleep(0.01)
            with metrics.span("op.a"):
                time.sleep(0.02)
                with metrics.span("op.a.b"):
                    time.sleep(0.01)
            with metrics.span("op.a"):
                time.sleep(0.005)
        with metrics.span("other"):
            time.sleep(0.001)
    rows = {r[1]: r for r in metrics._spans}
    by_name = {}
    for name, sid, parent, op, s, e in metrics._spans:
        by_name.setdefault(name, []).append((sid, parent, op, s, e))
    (op_id, op_parent, op_op, _, _), = by_name["op"]
    assert op_parent is None and op_op == op_id
    for sid, parent, op, s, e in by_name["op.a"]:
        assert parent == op_id and op == op_id
    (b_id, b_parent, b_op, _, _), = by_name["op.a.b"]
    assert rows[b_parent][0] == "op.a" and b_op == op_id
    (o_id, o_parent, o_op, _, _), = by_name["other"]
    assert o_parent is None and o_op == o_id != op_id
    snap = metrics.snapshot()
    assert snap["ops"] == 2
    sp = snap["spans"]
    assert sp["op.a"]["n"] == 2 and sp["op"]["n"] == 1
    # self time: the span less what its children cover
    assert sp["op"]["self_s"] == pytest.approx(
        sp["op"]["total_s"] - sp["op.a"]["total_s"], abs=1e-9)
    assert sp["op.a"]["self_s"] == pytest.approx(
        sp["op.a"]["total_s"] - sp["op.a.b"]["total_s"], abs=1e-9)
    assert 0.009 <= sp["op"]["self_s"] < 0.05
    assert 0.024 <= sp["op.a"]["self_s"] < 0.08
    assert sp["op.a.b"]["self_s"] == sp["op.a.b"]["total_s"] >= 0.009


def test_counters_per_op_and_reset():
    metrics.count("a", 2)
    with metrics.recording(sync=False):
        with metrics.span("op"):
            metrics.count("a")
            metrics.count("b", 5)
        metrics.count("a")                      # outside every op
    assert metrics.snapshot()["counts"] == {"a": 4, "b": 5}
    assert metrics.snapshot(profiled=False)["counts"] == {"a": 1, "b": 5}
    assert metrics.snapshot(profiled=True) == {"spans": {}, "counts": {},
                                               "ops": 0}
    metrics.reset()
    assert metrics.snapshot() == {"spans": {}, "counts": {}, "ops": 0}
    metrics.count("a")
    assert metrics.snapshot()["counts"] == {"a": 1}


def test_profiled_ops_apart_from_the_others():
    with metrics.recording(sync=False):
        with metrics.span("plain"):
            metrics.count("n")
        with profile(activities=[ProfilerActivity.CPU]):
            with metrics.span("profiled"):
                metrics.count("n", 3)
    assert set(metrics.snapshot(profiled=False)["spans"]) == {"plain"}
    assert metrics.snapshot(profiled=True)["counts"] == {"n": 3}
    assert metrics.snapshot()["ops"] == 2


def test_clock_is_the_profilers():
    """A span's recorded start and end agree with its profiler range in
    a CPU profile within 50 us, after one warm-up span."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.recording(sync=False):
            with metrics.span("warm"):
                pass
            with metrics.span("clock"):
                time.sleep(0.002)
    name, _, _, _, s, e = metrics._spans[-1]
    assert name == "clock"
    ev = [x for x in _profile_events(prof)
          if x.name() == metrics.SPAN_PREFIX + "clock"]
    assert len(ev) == 1
    es = ev[0].start_ns()
    ee = es + ev[0].duration_ns()
    assert abs(s - es) <= 50_000 and abs(e - ee) <= 50_000, (s - es, e - ee)


def test_profile_to_shows_spans(tmp_path):
    """profile_to records the program's spans, as SPAN_PREFIX ranges, in
    its Chrome trace; after it recording is off again."""
    import json

    with metrics.profile_to(str(tmp_path)):
        with metrics.span("region"):
            torch.arange(1000).sum()
    with metrics.span("after"):
        torch.arange(10).sum()
    events = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert metrics.SPAN_PREFIX + "region" in names
    assert metrics.SPAN_PREFIX + "after" not in names
    assert set(metrics.snapshot()["spans"]) == {"region"}


def test_a_synchronisation_s_wait_goes_to_the_span_it_blocks(monkeypatch):
    """The recorder's synchronisations are kept apart from the program's
    waits, as sync_s: a span's opening one waits for work its parent
    enqueued and is the parent's (nobody's for an op); its closing one
    is its own.  The stand-in synchronisations sleep 40 ms (the op's
    opening), 30 ms (the child's opening), 5 ms (the child's closing)
    and 2 ms (the op's closing)."""
    sleeps = iter([0.040, 0.030, 0.005, 0.002])
    with metrics.recording(sync=False):
        monkeypatch.setattr(metrics, "_sync",
                            lambda: time.sleep(next(sleeps)))
        with metrics.span("op"):
            with metrics.span("op.child"):
                pass
    sp = metrics.snapshot()["spans"]
    assert 0.005 <= sp["op.child"]["sync_s"] < 0.030
    assert 0.032 <= sp["op"]["sync_s"] < 0.070
    for v in sp.values():
        assert v["wait_s"] == 0
        assert v["sync_s"] <= v["self_s"] + 1e-6


def test_to_host_of_a_host_tensor_adds_no_wait():
    with metrics.recording(sync=False):
        with metrics.span("op"):
            metrics.to_host(torch.arange(4))
            metrics.to_device(np.arange(4), "cpu")
    assert metrics.snapshot()["spans"]["op"]["wait_s"] == 0


class _Across:
    """A host tensor whose copy to a device takes 5 ms."""
    device = torch.device("cpu")

    def __init__(self):
        self.calls = 0

    def to(self, device):
        self.calls += 1
        time.sleep(0.005)
        return types.SimpleNamespace(device=torch.device(device))

    def numel(self):
        return 4

    def element_size(self):
        return 2


def test_to_device_times_a_copy_across_while_recording():
    t = _Across()
    metrics.to_device(t, "meta")                    # off: not timed
    with metrics.recording(sync=False):
        with metrics.span("op"):
            with metrics.span("op.to_device"):
                metrics.to_device(t, "meta")
    assert t.calls == 2
    snap = metrics.snapshot()
    assert snap["counts"]["copy.h2d_bytes"] == 2 * 8
    sp = snap["spans"]
    assert sp["op"]["wait_s"] == 0
    assert 0.005 <= sp["op.to_device"]["wait_s"] \
        <= sp["op.to_device"]["self_s"]


class _Stream:
    """A device's current stream whose synchronise sleeps 5 ms."""

    def __init__(self):
        self.calls = 0

    def synchronize(self):
        self.calls += 1
        time.sleep(0.005)


def test_sync_stream_waits_for_the_stream_and_times_it_while_recording(
        monkeypatch):
    stream = _Stream()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: stream)
    metrics.sync_stream("cuda")                     # off: not timed
    assert stream.calls == 1
    with metrics.recording(sync=False):
        metrics.sync_stream("cuda")                 # no span: nobody's
        with metrics.span("op"):
            with metrics.span("op.to_host"):
                metrics.sync_stream("cuda")
    assert stream.calls == 3
    sp = metrics.snapshot()["spans"]
    assert sp["op"]["wait_s"] == 0
    assert 0.005 <= sp["op.to_host"]["wait_s"] <= sp["op.to_host"]["self_s"]


def test_recording_off_reads_no_clock_and_spans_stay_the_shared_no_op(
        monkeypatch):
    def refuse():
        raise AssertionError("clock read while recording is off")

    monkeypatch.setattr(metrics, "time",
                        types.SimpleNamespace(time_ns=refuse))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: _Stream())
    assert metrics.span("a") is metrics.span("b") is metrics._OFF
    with metrics.span("a"):
        assert metrics.to_host(torch.arange(3)).sum() == 3
        metrics.to_device(_Across(), "meta")
        metrics.sync_stream("cuda")
    assert metrics.snapshot()["spans"] == {}


def test_profiled_spans_carry_the_host_fields():
    """Under a profiler the recorder does not synchronise: a span's wait
    is the program's own blocking alone, none on the CPU, and its sync
    is 0."""
    with metrics.recording(sync=False):
        with profile(activities=[ProfilerActivity.CPU]):
            with metrics.span("profiled"):
                with metrics.span("profiled.part"):
                    torch.arange(1000).sum()
    sp = metrics.snapshot(profiled=True)["spans"]
    assert set(sp) == {"profiled", "profiled.part"}
    for v in sp.values():
        assert set(v) == {"n", "total_s", "self_s", "wait_s", "sync_s"}
        assert v["wait_s"] == v["sync_s"] == 0


def _recorded(fn):
    """fn() under recording(sync=False) on a fresh recorder: (its result,
    the snapshot)."""
    metrics.reset()
    with metrics.recording(sync=False):
        out = fn()
    return out, metrics.snapshot()


def _one_op(snap, op):
    assert snap["ops"] == 1
    assert snap["spans"][op]["n"] == 1
    assert snap["spans"][op]["self_s"] >= 0


def test_manifest_encode_and_decode_spans(data):
    plain = M.compress_with_manifest(data, level=2, device="cpu")
    (stream, man), snap = _recorded(
        lambda: M.compress_with_manifest(data, level=2, device="cpu"))
    assert stream == plain[0] and man.to_bytes() == plain[1].to_bytes()
    assert set(snap["spans"]) == ENCODE | {"encode.hints"}
    _one_op(snap, "encode")
    assert not any(k.startswith("copy.") for k in snap["counts"])

    out, snap = _recorded(lambda: M.decode_all(stream, man, device="cpu"))
    assert out == M.decode_all(stream, man, device="cpu") == data
    assert set(snap["spans"]) == DECODE
    _one_op(snap, "decode")
    assert "decode.blocks_fallback" not in snap["counts"]


def test_decode_all_counts_the_blocks_it_sends_to_the_host(data):
    stream, man = M.compress_with_manifest(data, level=2, device="cpu")
    bad = corrupt_block3(stream, man)
    metrics.reset()
    with metrics.recording(sync=False):
        try:
            M.decode_all(bad, man, device="cpu")
        except (D.InflateError, ValueError, IndexError):
            pass
    snap = metrics.snapshot()
    assert snap["counts"]["decode.blocks_fallback"] >= 1
    assert "decode.fallback" in snap["spans"]
    _one_op(snap, "decode")


@pytest.fixture(scope="module")
def hintless(data):
    """data's level-2 stream and its manifest without entry phases."""
    return M.compress_with_manifest(data, level=2, hints=False,
                                    device="cpu")


def test_hintless_decode_all_spans_and_path(data, hintless):
    """K6's path (the plain version on the CPU) in decode_all: the
    operands, their copies, the inflate and the rows back, one op, and
    the decoder that served counted once."""
    stream, man = hintless
    assert man.hints is None
    out, snap = _recorded(lambda: M.decode_all(stream, man, device="cpu"))
    assert out == data
    assert set(snap["spans"]) == HINTLESS
    _one_op(snap, "decode")
    assert snap["counts"] == {"decode.path.pallas_scalar": 1}


def test_hintless_decode_all_counts_every_block_it_sends_to_the_host(
        hintless):
    """A block K6 flags sends the whole stream to the host."""
    stream, man = hintless
    bad = corrupt_block3(stream, man)
    metrics.reset()
    with metrics.recording(sync=False):
        try:
            M.decode_all(bad, man, device="cpu")
        except (D.InflateError, ValueError, IndexError):
            pass
    snap = metrics.snapshot()
    assert snap["counts"]["decode.blocks_fallback"] == len(man.blocks)
    assert "decode.path.pallas_scalar" not in snap["counts"]
    assert "decode.fallback" in snap["spans"]
    _one_op(snap, "decode")


def test_compress_and_forced_decompress_spans(data):
    plain = D.compress(data, 2, device="cpu")
    stream, snap = _recorded(lambda: D.compress(data, 2, device="cpu"))
    assert stream == plain
    assert set(snap["spans"]) == ENCODE
    _one_op(snap, "encode")

    raw = zlib.compress(data, 6)[2:-4]
    st = {}
    out, snap = _recorded(lambda: D.decompress(
        raw, device="cpu", force_device=True, stats=st))
    assert out == D.decompress(raw, device="cpu", force_device=True) == data
    assert set(snap["spans"]) == DECODE | {"decode.skeleton"}
    _one_op(snap, "decode")
    assert st["device_path"] == "wave"
    # the 100,551-byte stream walks in two 64 KiB pieces given two cores;
    # the block headers past 64 KiB are stored, the first not on a byte
    # boundary and the second final, so no piece is a candidate's and
    # the stitch walks both blocks in order
    two = len(os.sched_getaffinity(0)) > 1
    assert snap["counts"] == {
        "decode.path.wave": 1, "skeleton.pieces": int(two),
        "skeleton.pieces_taken": 0, "skeleton.blocks_rewalked": 2 * two}

    out, snap = _recorded(lambda: D.decompress(raw, device=None))
    assert out == data
    assert set(snap["spans"]) == {"decode", "decode.fallback"}
    assert snap["counts"] == {"decode.path.native_host": 1}


def _tokenized(data, level):
    """One tokenize_block of data's first block, recorded as one op."""
    from deflate_tpu_torch.models import encoder as E

    blocks, blens = M.split_blocks(data[:E.N])
    block = torch.from_numpy(blocks)
    blen = torch.from_numpy(blens)

    def op():
        with metrics.span("encode"):
            return E.tokenize_block(block, blen, level)
    return _recorded(op)[1], block.shape


def test_level3_search_spans_and_pairs(data):
    snap, (B, n) = _tokenized(data, 3)
    spans = snap["spans"]
    assert {k: spans[k]["n"] for k in spans if k.startswith("lz77.")} == {
        "lz77.far_cut": 1, "lz77.find_matches": 1, "lz77.chain": 1,
        "lz77.tier": 2, "lz77.extend": 1, "lz77.greedy_parse": 1}
    assert snap["counts"] == {"lz77.pairs": 3 * 48 * B * n}


def test_level2_search_spans_and_pairs(data):
    snap, (B, n) = _tokenized(data, 2)
    assert {k for k in snap["spans"] if k.startswith("lz77.")} == {
        "lz77.find_matches", "lz77.chain", "lz77.extend",
        "lz77.greedy_parse"}
    assert snap["spans"]["lz77.chain"]["n"] == 1
    assert snap["counts"] == {"lz77.pairs": 4 * B * n}


@pytest.mark.parametrize("level", [2, 3])
def test_lz77_self_times_sum_to_the_outer_lz77_spans(data, level):
    """The search spans nest in lz77.find_matches, so the lz77. prefix
    that self_ms_per_MiB.lz77 sums reads the same total as before."""
    snap, _ = _tokenized(data, level)
    spans = snap["spans"]
    outer = sum(spans[k]["total_s"] for k in (
        "lz77.find_matches", "lz77.greedy_parse", "lz77.far_cut")
        if k in spans)
    inner = sum(v["self_s"] for k, v in spans.items()
                if k.startswith("lz77."))
    assert inner == pytest.approx(outer, rel=1e-9, abs=1e-9)
    assert spans["lz77.find_matches"]["self_s"] > 0


@pytest.mark.cuda
def test_kernel_counters_on_phase_a(cuda_device):  # noqa: F811
    """chip_smoke's phase A (the 8 MiB corpus at seed 42: a level-2
    manifest encode, then its hinted decode) launches K1 3 times, K2 3,
    K3 9 and K4 3 (K3 three a wave_decode: its merge re-compaction is
    K12's), K9 once (one tokenize_block), K10 once (its one hash pass),
    and K11 and K12 once a wave_decode; the copies are counted on the
    card."""
    from chip_smoke import CORPUS_BYTES, SEED, make_corpus
    import numpy as np

    data = make_corpus(np.random.default_rng(SEED), CORPUS_BYTES)
    s, m = M.compress_with_manifest(data, level=2, device=cuda_device)
    assert M.decode_all(s, m, device=cuda_device) == data     # warm-up
    metrics.reset()
    s, m = M.compress_with_manifest(data, level=2, device=cuda_device)
    assert M.decode_all(s, m, device=cuda_device) == data
    torch.cuda.synchronize()
    c = metrics.snapshot()["counts"]
    kernels = {k: v for k, v in c.items() if k.startswith("kernel.")}
    assert kernels == {"kernel.K1": 3, "kernel.K2": 3, "kernel.K3": 9,
                       "kernel.K4": 3, "kernel.K9": 1, "kernel.K10": 1,
                       "kernel.K11": 3, "kernel.K12": 3}
    assert c["copy.h2d"] >= 3 and c["copy.d2h"] >= 5
    assert c["copy.h2d_bytes"] >= len(data)
