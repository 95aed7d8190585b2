"""The span-and-counter recorder (deflate_tpu_torch/utils/metrics.py) and
the spans and counters at the layer boundaries of the encode and decode
paths.  No JAX: the CPU cases hold the port against itself with recording
off, and the one card case runs where JAX is absent:

    python -m pytest tests/test_torch_tracing.py --noconftest -p no:randomly -o addopts=""
"""
import time
import zlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import deflate_tpu_torch as D
from deflate_tpu_torch.runtime import manifest as M
from deflate_tpu_torch.utils import metrics
from torch_helpers import corpus, corrupt_block3, cuda_device  # noqa: F401

ENCODE = {"encode", "encode.split", "lz77.find_matches",
          "lz77.greedy_parse", "encode.trees", "encode.choose",
          "encode.emit", "encode.to_host"}
DECODE = {"decode", "decode.headers", "decode.windows", "decode.to_device",
          "decode.stages", "wave.resolve_litval", "wave.merge_match_runs",
          "decode.fill", "decode.to_host"}


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
    assert snap["counts"] == {"decode.path.wave": 1}

    out, snap = _recorded(lambda: D.decompress(raw, device=None))
    assert out == data
    assert set(snap["spans"]) == {"decode", "decode.fallback"}
    assert snap["counts"] == {"decode.path.native_host": 1}


@pytest.mark.cuda
def test_kernel_counters_on_phase_a(cuda_device):  # noqa: F811
    """chip_smoke's phase A (the 8 MiB corpus at seed 42: a level-2
    manifest encode, then its hinted decode) launches K1 3 times, K2 3,
    K3 12 and K4 3, as its module counters counted before; the copies
    are counted on the card."""
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
    assert kernels == {"kernel.K1": 3, "kernel.K2": 3, "kernel.K3": 12,
                       "kernel.K4": 3}
    assert c["copy.h2d"] >= 3 and c["copy.d2h"] >= 5
    assert c["copy.h2d_bytes"] >= len(data)
