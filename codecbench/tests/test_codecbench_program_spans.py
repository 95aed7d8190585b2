"""The readers of the program's own spans and counters, the launch and
idle reduction by program span, and the outside spans' targets."""
import importlib
import json
import os
import types

import pytest

from codecbench import harness, program, span_profile, trace
from helpers import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
P = "dt."


def test_launches_go_to_the_innermost_program_span():
    host = span_profile.host_spans(
        [(0.0, 10.0)],
        [(P + "encode", 0.5, 9.5), (P + "lz77.greedy_parse", 1.0, 4.0),
         (P + "encode.emit", 5.0, 8.0)], P)
    got = span_profile.launch_counts([0.2, 0.7, 1.5, 2.0, 3.9, 6.0, 9.7,
                                      11.0], host)
    assert got == {"op, other host work": 2, "encode": 1,
                   "lz77.greedy_parse": 3, "encode.emit": 1,
                   "between ops": 1}


def test_idle_is_named_by_the_finest_program_span():
    events = [
        ("codecbench.window", 0.0, 10.0, False),
        ("codecbench.op", 0.0, 10.0, False),
        (P + "decode", 0.5, 9.0, False),
        (P + "decode.skeleton", 1.0, 3.0, False),
        (P + "wave.resolve_litval", 4.0, 6.0, False),
        ("cudaLaunchKernel", 4.5, 4.51, False),
        ("cuLaunchKernel", 6.5, 6.51, False),
        ("cudaMemcpyAsync", 2.0, 2.01, False),
        ("aten::add", 6.6, 6.7, False),
        ("k1", 3.0, 4.0, True),
        ("Memcpy HtoD (Pageable -> Device)", 6.0, 6.5, True),
        ("k2", 7.0, 9.5, True),
    ]
    r = span_profile.reduce_events(events, P)
    assert r["launch_calls"] == 2 and r["kernels"] == 2
    assert r["copies_on_card"] == 1
    assert r["copies_on_card_by_kind"] == {"Memcpy HtoD": 1}
    assert r["launch_calls_by_span"] == {"wave.resolve_litval": 1,
                                         "decode": 1}
    assert r["copy_calls"] == 1
    assert r["copy_calls_by_span"] == {"decode.skeleton": 1}
    # each idle stretch goes by its midpoint: 0-3 (1.5) skeleton, 4-6
    # resolve_litval, 6.5-7 decode, 9.5-10 the op alone
    assert r["idle_by_span_s"] == pytest.approx({
        "op, other host work": 0.5, "decode.skeleton": 3.0,
        "wave.resolve_litval": 2.0, "decode": 0.5})
    assert r["idle_s"] == pytest.approx(6.0)


def test_without_program_spans_idle_keeps_the_harness_labels():
    events = [("codecbench.window", 0.0, 4.0, False),
              ("codecbench.op", 0.0, 2.5, False),
              ("k", 1.0, 2.0, True)]
    r = span_profile.reduce_events(events, P)
    assert r["idle_by_span_s"] == pytest.approx(
        {"op, other host work": 1.0, "between ops": 2.0})
    assert r["launch_calls"] == 0


def _ctx(n_ops, chunk=2 ** 20):
    run = types.SimpleNamespace(chunks=[b"x" * chunk])
    ops = [harness.Op(0, float(k), k + 0.5, b"", None)
           for k in range(n_ops)]
    return harness.Context(run, ops, 1.0)


def _read(name, ctx):
    return harness.reader(name).read(ctx)


NEW = [m["name"] for m in BENCH["per_layer"]
       if m["name"].startswith(("self_ms_per_MiB.", "copies_per_op."))]


def test_readers_are_silent_when_nothing_was_recorded(monkeypatch):
    assert len(NEW) == 8
    monkeypatch.setattr(program, "window", lambda: None)
    for name in NEW:
        assert _read(name, _ctx(3)) is None, name


def test_readers_are_silent_without_the_program_s_recorder(monkeypatch):
    monkeypatch.setattr(program, "recorder", lambda: None)
    assert program.window() is None
    for name in NEW:
        assert _read(name, _ctx(3)) is None, name


def test_readers_read_self_time_and_copies_per_op(monkeypatch):
    snap = {"ops": 2, "counts": {"copy.h2d": 6, "copy.d2h": 10,
                                 "copy.h2d_bytes": 99, "kernel.K1": 6},
            "spans": {
                "encode": {"n": 2, "total_s": 1.0, "self_s": 0.01},
                "lz77.find_matches": {"n": 2, "total_s": .1, "self_s": .1},
                "lz77.greedy_parse": {"n": 2, "total_s": .3, "self_s": .3},
                "encode.trees": {"n": 2, "total_s": .5, "self_s": .06},
                "encode.emit": {"n": 2, "total_s": .04, "self_s": .04},
                "encode.split": {"n": 2, "total_s": .002, "self_s": .002},
                "encode.to_host": {"n": 2, "total_s": .01, "self_s": .01},
                "wave.resolve_litval": {"n": 8, "total_s": .2,
                                        "self_s": .2}}}
    monkeypatch.setattr(program, "window", lambda: snap)
    ctx = _ctx(5, chunk=2 * 2 ** 20)        # 2 MiB an op
    # (0.1 + 0.3) s over 2 ops, 2 MiB each: 100 ms per MiB
    assert _read("self_ms_per_MiB.lz77", ctx) == pytest.approx(100)
    assert _read("self_ms_per_MiB.encode_emit", ctx) == pytest.approx(25)
    assert _read("self_ms_per_MiB.encode_to_host", ctx) == pytest.approx(3)
    assert _read("self_ms_per_MiB.wave_glue", ctx) == pytest.approx(50)
    assert _read("self_ms_per_MiB.decode_prep", ctx) is None
    assert _read("copies_per_op.encode", ctx) == 8
    assert _read("copies_per_op.decode", ctx) == 8


def test_readers_on_the_program_s_recorder():
    """The real recorder, driven by hand: two ops recorded with no
    profiler, none recorded yields None."""
    m = program.recorder()
    m.stop()
    m.reset()
    try:
        assert program.window() is None
        with m.recording(sync=False):
            for _ in range(2):
                with m.span("decode"):
                    with m.span("wave.merge_match_runs"):
                        m.count("copy.d2h")
        ctx = _ctx(2)
        assert _read("self_ms_per_MiB.wave_glue", ctx) > 0
        assert _read("copies_per_op.decode", ctx) == 1
        assert _read("self_ms_per_MiB.decode_transfer", ctx) is None
    finally:
        m.stop()
        m.reset()


def test_every_outside_span_names_a_function_of_the_port():
    """The harness's timed and labelled spans wrap module attributes; one
    that a change renamed or moved would fall silent without an error."""
    seen = 0
    for m in BENCH["per_layer"]:
        for mod, fn in getattr(harness.reader(m["name"]), "SPANS", []):
            assert callable(getattr(importlib.import_module(mod), fn)), (
                m["name"], mod, fn)
            seen += 1
    assert seen >= 9


def test_span_names_the_readers_use_are_the_program_s():
    """Every span a self-time reader sums is one the port opens."""
    import subprocess

    src = subprocess.run(
        ["grep", "-rhoE", r'span\("[a-z0-9_.]+"\)',
         os.path.join(ROOT, "deflate_tpu_torch")],
        capture_output=True, text=True).stdout
    opened = {s[6:-2] for s in src.split()}
    for split, names in program.SELF_SPANS.items():
        for n in names:
            assert any(program.matches(o, [n]) for o in opened), (split, n)
    assert trace.SPAN.startswith("codecbench.")
