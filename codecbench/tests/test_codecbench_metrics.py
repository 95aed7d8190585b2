"""The metric arithmetic, on synthetic ops, spans and intervals."""
import types

import pytest

from codecbench import harness, trace
from codecbench.yardstick import HBM_BYTES_PER_S, p95


def test_union_merges_overlapping_and_touching_intervals():
    assert trace.union([(5, 7), (0, 2), (1, 3), (3, 4), (6, 6.5)]) == [
        (0, 4), (5, 7)]


def test_reduce_counts_overlapping_kernels_once_in_busy_time():
    device = [("k1", 1.0, 3.0, False), ("k2", 2.0, 4.0, False),
              ("Memcpy HtoD", 6.0, 7.0, True),
              ("k3", 9.0, 12.0, False)]        # runs past the window
    host = [(trace.OP, 0.0, 5.0), (trace.OP, 5.5, 10.0),
            (trace.SPAN + "wave.prepare_windows", 4.0, 5.0)]
    r = trace.reduce(device, host, 0.0, 10.0)
    assert r["busy"] == pytest.approx(3 + 1 + 1)       # 1-4, 6-7, 9-10
    assert r["kernel"] == pytest.approx(2 + 2 + 1)     # copies left out
    assert r["window"] == 10.0
    assert dict(r["device_ops"]) == pytest.approx(
        {"k1": 2.0, "k2": 2.0, "Memcpy HtoD": 1.0, "k3": 1.0})
    # idle 0-1 (op), 4-6 (prepare_windows 4-5, between ops 5-5.5 and the
    # op 5.5-6 by the midpoint 5.0: the span), 7-9 (op)
    assert dict(r["idle_gaps"]) == pytest.approx(
        {"op, other host work": 3.0, "wave.prepare_windows": 2.0})


def test_idle_outside_every_op_is_between_ops():
    r = trace.reduce([("k", 0.0, 1.0, False)], [], 0.0, 4.0)
    assert r["idle_gaps"] == [["between ops", 3.0]]
    assert trace.reduce([], [], 0.0, 2.0)["busy"] == 0


def test_p95_is_nearest_rank_over_pooled_ops():
    lat = list(range(1, 201))              # 200 ops: p95 is the 190th
    assert p95(lat) == 190
    assert p95([3.0]) == 3.0
    assert p95([5, 1, 4, 2, 3] * 4) == 5


def _ctx(lat, spans=None, profile=None, io_bytes=0, chunk=2 ** 20):
    run = types.SimpleNamespace(chunks=[b"x" * chunk, b"y" * chunk])
    ops, t = [], 100.0
    for k, dt in enumerate(lat):
        ops.append(harness.Op(k % 2, t, t + dt, b"", None))
        t += dt
    return harness.Context(run, ops, 12.5, spans or {}, profile, io_bytes,
                           "NVIDIA H100 80GB HBM3")


def _read(name, ctx):
    return harness.reader(name).read(ctx)


def test_rates_take_all_bytes_over_the_whole_window():
    ctx = _ctx([0.5, 0.25, 0.25])          # 3 MiB in 1 s
    for name in ("encode_MBps", "decode_MBps"):
        assert _read(name, ctx) == pytest.approx(3 * 2 ** 20 / 1e6)
    assert _read("setup_s", ctx) == 12.5
    assert _read("op_p95_ms", ctx) == pytest.approx(500)


def test_span_metrics_per_mib_and_silent_without_spans():
    lz = "deflate_tpu_torch.ops.lz77."
    ctx = _ctx([0.5, 0.5], {lz + "find_matches": 0.1,
                            lz + "greedy_parse": 0.3})
    assert _read("lz77_ms_per_MiB", ctx) == pytest.approx(200)
    assert _read("encode_rest_ms_per_MiB", ctx) == pytest.approx(300)
    assert _read("wave_glue_ms_per_MiB", ctx) is None
    assert _read("decode_prep_ms_per_MiB", ctx) is None


def test_roofline_and_idle_from_the_profile():
    prof = {"busy": 0.2, "kernel": 0.1, "window": 1.0}
    ctx = _ctx([0.5], profile=prof, io_bytes=3.35e9)   # 1 ms at the peak
    assert HBM_BYTES_PER_S["NVIDIA H100 80GB HBM3"] == 3.35e12
    for k in ("encode", "decode"):
        assert _read(f"kernels_roofline.{k}", ctx) == pytest.approx(1.0)
        assert _read(f"device_idle_pct.{k}", ctx) == pytest.approx(80.0)
    assert _read("kernels_roofline.encode", _ctx([0.5])) is None
    ctx.device_kind = "an unknown card"
    assert _read("kernels_roofline.encode", ctx) is None


def test_read_metrics_leaves_out_what_finds_nothing():
    entries = [{"name": "setup_s", "unit": "s"},
               {"name": "wave_glue_ms_per_MiB", "unit": "ms/MiB"}]
    assert harness.read_metrics(entries, _ctx([0.5])) == {
        "setup_s": {"value": 12.5, "unit": "s"}}


def test_timed_spans_sum_and_restore():
    import codecbench.yardstick as Y

    orig, totals, syncs = Y.p95, {}, []
    p = trace.timed([("codecbench.yardstick", "p95")], totals,
                    lambda: syncs.append(1))
    assert Y.p95([1, 2]) == 2 and Y.p95([3]) == 3
    p.undo()
    assert Y.p95 is orig and len(syncs) == 4
    assert list(totals) == ["codecbench.yardstick.p95"]


def test_idle_is_named_by_the_innermost_span_the_host_was_in():
    label = trace.host_labels([
        (trace.OP, 0.0, 10.0), (trace.SPAN + "lz77.find_matches", 1.0, 3.0),
        (trace.SPAN + "wave.resolve_litval", 1.5, 2.0),
        (trace.OP, 11.0, 12.0)])
    assert label(1.7) == "wave.resolve_litval"
    assert label(2.5) == "lz77.find_matches"
    assert label(4.0) == "op, other host work"
    assert label(10.5) == "between ops"
    assert label(11.5) == "op, other host work"
    assert label(-1.0) == "between ops"


def test_short_names_drop_the_namespaces():
    n = ("void at::native::vectorized_elementwise_kernel<4, "
         "at::native::(anonymous namespace)::CompareEqFunctor<int> >(int)")
    assert trace.short_name(n) == (
        "vectorized_elementwise_kernel<4, CompareEqFunctor<int> >(int)")
    assert len(trace.short_name("x" * 500)) == 160
    assert trace.is_copy("Memcpy DtoH (Device -> Pageable)")
    assert not trace.is_copy("dt_route_kernel")
