"""CUDA kernels of deflate_tpu_torch against their plain versions, and
the main path on the card against the CPU.  Every test skips without an
NVIDIA GPU.  This file imports no JAX, so it also runs where JAX is
absent:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:randomly -o addopts=""
"""
import os
import zlib

import numpy as np
import pytest
import torch

import deflate_tpu_torch as D
from chip_smoke import deflate_raw, speculative_cases
from deflate_tpu_torch.models import decoder as DEC
from deflate_tpu_torch.models import encoder as E
from deflate_tpu_torch.models import wave_decoder as WD
from deflate_tpu_torch.ops import bitpack as BP
from deflate_tpu_torch.ops import block_inflate as BI
from deflate_tpu_torch.ops import huffman as H
from deflate_tpu_torch.ops import inflate_scan as IS
from deflate_tpu_torch.ops import lz77 as LZ
from deflate_tpu_torch.ops import pack as PK
from deflate_tpu_torch.ops import tree
from deflate_tpu_torch.ops import wave as W
from deflate_tpu_torch.ops import wave_fill as WF
from deflate_tpu_torch.ops import wave_route as WR
from deflate_tpu_torch.ops import wave_stagea as WS
from deflate_tpu_torch.runtime import manifest as M
from deflate_tpu_torch.utils import metrics
from torch_helpers import (NM, PACK_CASES, PARSE_CASES,  # noqa: F401
                           PARSE_TILES, ROUTE_CASES, assert_same, corpus,
                           cuda_device, fill_case, hist_case, litval_case,
                           long_code_case, long_match_streams, merge_case,
                           monotone_instance, pack_case, parse_case,
                           random_code_case, route_case, search_blocks)

pytestmark = pytest.mark.cuda


def test_k1_kernel_matches_plain(cuda_device):
    """K1 against depths_plain and depths_jump on the whole [T, 1024]
    output: random trees, nz = 0, 1 and 2, Fibonacci chains whose deepest
    leaves sit at nz - 1, and n = 512 with every symbol used."""
    rng = np.random.default_rng(1)
    fib = [1, 1]
    while len(fib) < 36:
        fib.append(fib[-1] + fib[-2])
    for n in (288, 30, 19, 512):
        f = rng.integers(0, 300, (771, n)).astype(np.int32)
        f[rng.random(f.shape) < 0.3] = 0
        f[:3] = 0
        f[1, 5] = 9
        f[2, [0, n - 1]] = 4
        f[3:6] = 0
        f[3, :min(n, 36)] = fib[:min(n, 36)]
        f[4, n - min(n, 36):] = rng.permutation(fib[:min(n, 36)])
        f[5] = rng.integers(1, 5000, n)
        lw, _, nz = H._sort_leaves(torch.from_numpy(f).to(cuda_device))
        got = tree.depths_kernel(lw, nz)
        want = tree.depths_plain(lw, nz)
        jump = tree.depths_jump(lw, nz)
        torch.cuda.synchronize()
        assert_same(got, want, f"K1 n={n}")
        assert_same(got, jump, f"K1 vs jump n={n}")
        assert int(got[3, :n].max()) == int(nz[3]) - 1


def test_k2_kernel_matches_plain(cuda_device):
    data = corpus(4, seed=21)
    stream, man = M.compress_with_manifest(data, level=2, device="cpu")
    offs = [b[0] for b in man.blocks]
    md = W.parse_headers_host(stream, offs)
    huff = [i for i in range(len(offs)) if md["btype"][i] != 0]
    W64 = 4224
    nw = W.prepare_windows(stream, md["data_start"][huff], W64)
    hints = man.hint_array()[huff]
    hs = np.full((len(huff), W64), W.HINT_NONE, np.int32)
    hs[:, :hints.shape[1]] = hints
    mds = torch.stack([torch.from_numpy(np.asarray(md[k])[huff])
                       for k in W.MD_KEYS], 1).to(cuda_device)
    nwt = torch.from_numpy(nw).to(cuda_device)
    hst = torch.from_numpy(hs).to(cuda_device)
    stop = torch.full((len(huff),), 1000, dtype=torch.int32,
                      device=cuda_device)
    for st, ml, mdx in ((None, 15, 15), (stop, 15, 15), (None, 12, 13)):
        got = WS.decode_mark_kernel(nwt, hst, mds, W64, st, ml, mdx)
        want = WS.decode_mark_plain(nwt, hst, mds, W64, st, ml, mdx)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ("A0c", "P1c", "sums")):
            assert_same(g, w, name)


def test_k3_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(7)
    for left in (True, False):
        pays, delta = monotone_instance(rng, 4, 33792, left)
        args = ([torch.from_numpy(p).to(cuda_device) for p in pays],
                torch.from_numpy(delta).to(cuda_device), 16, left)
        (ga, gb), gd = WR.route_kernel(*args)
        (wa, wb), wd = WR.route_plain(*args)
        torch.cuda.synchronize()
        assert_same(gd, wd, "dout")
        assert_same(ga, wa, "payload 0")
        assert_same(gb, wb, "payload 1")


@pytest.mark.parametrize("P,left,B,L,rounds,kind",
                         [pytest.param(*c[1:], id=c[0]) for c in ROUTE_CASES])
@pytest.mark.parametrize("pad", [0, 4, 7], ids=["rows", "stride+4",
                                                "stride+7"])
def test_k3_kernel_cases(cuda_device, P, left, B, L, rounds, kind, pad):
    """Every ROUTE_CASES entry, with the payloads as contiguous rows and
    as views into wider rows (16-byte aligned or not)."""
    pays, delta = route_case(P + 10 * B, P, left, B, L, rounds, kind)
    tp = []
    for p in pays:
        wide = torch.zeros((B, L + pad), dtype=torch.int32,
                           device=cuda_device)
        wide[:, :L] = torch.from_numpy(p).to(cuda_device)
        tp.append(wide[:, :L])
    td = torch.from_numpy(delta).to(cuda_device)
    gp, gd = WR.route_kernel(tp, td, rounds, left)
    wp, wd = WR.route_plain(tp, td, rounds, left)
    torch.cuda.synchronize()
    assert_same(gd, wd, "dout")
    for i, (g, w) in enumerate(zip(gp, wp)):
        assert_same(g, w, f"payload {i}")


def test_k4_kernel_matches_plain(cuda_device):
    lit, rec0, rec1, nmatch = fill_case(8)
    recs = WF.pack_fill_recs(torch.from_numpy(rec0), torch.from_numpy(rec1))
    args = [x.to(cuda_device) for x in
            (torch.from_numpy(lit), recs, torch.from_numpy(nmatch))]
    got = WF.fill_matches_kernel(*args)
    want = WF.fill_matches_plain(*args)
    torch.cuda.synchronize()
    assert_same(got, want, "K4")


def test_k4_kernel_matches_jump_on_decoder_rows(cuda_device, monkeypatch):
    """K4 against the torch form of its design (and the plain version) on
    fill_case and on every row of a level-2 hinted decode of corpus(4)."""
    lit, rec0, rec1, nmatch = fill_case(8)
    recs = WF.pack_fill_recs(torch.from_numpy(rec0), torch.from_numpy(rec1))
    cases = [[x.to(cuda_device) for x in
              (torch.from_numpy(lit), recs, torch.from_numpy(nmatch))]]
    data = corpus(4, seed=21)
    s, m = M.compress_with_manifest(data, level=2, device=cuda_device)
    kernel = WF.fill_matches

    def capture(*args):
        cases.append(args)
        return kernel(*args)

    monkeypatch.setattr(WF, "fill_matches", capture)
    out, _, err = WD.inflate_wave_device(
        s, [b[0] for b in m.blocks], [b[2] for b in m.blocks],
        m.hint_array(), device=cuda_device)
    assert len(cases) > 1 and not err.any()
    for i, args in enumerate(cases):
        got = WF.fill_matches_kernel(*args)
        torch.cuda.synchronize()
        assert_same(got, WF.fill_matches_jump(*args), f"K4 vs jump, case {i}")
        assert_same(got, WF.fill_matches_plain(*args), f"K4 vs plain, case {i}")


def test_k6_kernel_on_long_matches(cuda_device):
    """258-byte matches at distance 1, and one at distance 32768 - 258."""
    for name, st in long_match_streams().items():
        ops = [torch.from_numpy(x).to(cuda_device)
               for x in (*BI.prepare_blocks(st, [0]), BI.make_statics())]
        go, gs = BI.inflate_blocks_kernel(*ops)
        wo, ws = BI.inflate_blocks_plain(*ops)
        torch.cuda.synchronize()
        assert int(ws[0, 1]) == 0 and int(ws[0, 0]) == 32768, name
        assert_same(gs, ws, f"K6 status, {name}")
        assert_same(go, wo, f"K6 row, {name}")


def test_main_path_on_card_equals_cpu(cuda_device):
    data = corpus(4, seed=33)[:4 * 32768 - 77]
    s_cpu, m_cpu = M.compress_with_manifest(data, level=2, device="cpu")
    s_gpu, m_gpu = M.compress_with_manifest(data, level=2,
                                            device=cuda_device)
    assert s_gpu == s_cpu
    assert m_gpu.to_bytes() == m_cpu.to_bytes()
    assert M.decode_all(s_gpu, m_gpu, device=cuda_device) == data


def test_compress_entry_points_on_card_equal_cpu(cuda_device, tmp_path):
    """compress (segments 64 | 1), compress_many and compress_file on the
    card give the CPU's bytes."""
    data = corpus(65, seed=34)[:64 * 32768 + 5000]
    want = D.compress(data, 2, device="cpu")
    assert D.compress(data, 2, device=cuda_device) == want
    bufs = [data[:70000], b"", data[70000:70001], data[-40000:]]
    assert D.compress_many(bufs, 2, device=cuda_device) \
        == D.compress_many(bufs, 2, device="cpu")
    src, dst = tmp_path / "in.bin", tmp_path / "out.deflate"
    src.write_bytes(data)
    D.compress_file(str(src), str(dst), level=2, device=cuda_device)
    assert dst.read_bytes() == want
    assert zlib.decompress(want, -15) == data


def test_k5_kernel_matches_plain(cuda_device):
    lit, rec0, rec1, nmatch, sizes = hist_case()
    recs = np.stack([rec0, rec1], 2).reshape(len(sizes), 2 * NM)
    args = [torch.from_numpy(x).to(cuda_device)
            for x in (lit, recs, nmatch, sizes)]
    got = WF.fill_matches_hist_kernel(*args)
    want = WF.fill_matches_hist_plain(*args)
    torch.cuda.synchronize()
    assert_same(got, want, "K5")


def test_k5_kernel_on_a_long_plan(cuda_device, monkeypatch):
    """64 rows of a zlib-6 stream of 509-byte repeats (chains of ~4 k
    hops through earlier rows): the kernel against the plain version and
    the torch jump form on full rows, and the decode against the data."""
    rng = np.random.default_rng(23)
    pat = rng.integers(0, 256, 509, dtype=np.uint8)
    data = np.tile(pat, (64 << 15) // 509 + 1)[:64 << 15].tobytes()
    raw = zlib.compress(data, 6)[2:-4]
    calls = []
    kernel = WF.fill_matches_hist

    def capture(*args):
        calls.append(args)
        return kernel(*args)

    monkeypatch.setattr(WF, "fill_matches_hist", capture)
    out, err = WD.inflate_wave_planned(raw, WD.skeleton_plan(raw),
                                       device=cuda_device)
    assert out == data and not err.any()
    assert len(calls) == 1 and calls[0][0].shape[0] >= 64
    got = WF.fill_matches_hist_kernel(*calls[0])
    torch.cuda.synchronize()
    assert_same(got, WF.fill_matches_hist_plain(*calls[0]), "K5 vs plain")
    assert_same(got, WF.fill_matches_hist_jump(*calls[0]), "K5 vs jump")


def test_k6_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(8)
    data = corpus(3, seed=61)
    stream, man = M.compress_with_manifest(data, level=2, hints=False,
                                           device="cpu")
    c = zlib.compressobj(9, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    fixed = c.compress(b"hello hello hello world" * 40) + c.flush()
    bad = bytearray(stream)
    bad[len(bad) // 2] ^= 0x10
    for st, offs in ((stream, [b[0] for b in man.blocks]), (fixed, [0]),
                     (bytes(bad), [b[0] for b in man.blocks]),
                     (rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
                      [0, 8, 801])):
        ops = [torch.from_numpy(x).to(cuda_device)
               for x in (*BI.prepare_blocks(st, offs), BI.make_statics())]
        go, gs = BI.inflate_blocks_kernel(*ops)
        wo, ws = BI.inflate_blocks_plain(*ops)
        torch.cuda.synchronize()
        assert_same(gs[:, 1], ws[:, 1], "K6 err")
        ok = (ws[:, 1] == 0)[:, None]
        assert_same(torch.where(ok, gs, 0), torch.where(ok, ws, 0),
                    "K6 status")
        assert_same(torch.where(ok, go, 0), torch.where(ok, wo, 0),
                    "K6 rows")


def test_foreign_and_hintless_paths_on_card(cuda_device):
    data = corpus(3, seed=62)
    raw = zlib.compress(data, 6)[2:-4]
    st = {}
    assert D.decompress(raw, len(data), device=cuda_device,
                        force_device=True, stats=st) == data
    assert st["device_path"] == "wave"
    s, m = M.compress_with_manifest(data, level=2, hints=False,
                                    device=cuda_device)
    assert M.decode_all(s, m, device=cuda_device) == data


def test_forced_decode_of_a_chunk_walks_in_pieces(cuda_device):
    """decompress(force_device=True) of the benchmark's 8 MiB zlib-6
    chunk: the chunk back on the wave path, the skeleton walked in
    pieces wherever the process has two cores or more."""
    from codecbench.data.mixed_corpus import make_corpus

    chunk = make_corpus(np.random.default_rng((0, 0)), 8 << 20)
    raw = zlib.compress(chunk, 6)[2:-4]
    metrics.reset()
    assert D.decompress(raw, device=cuda_device, force_device=True) == chunk
    c = metrics.snapshot()["counts"]
    assert c["decode.path.wave"] == 1
    if len(os.sched_getaffinity(0)) > 1:
        assert c["skeleton.pieces"] >= 2


def test_hintless_decode_all_counts_k6_and_its_copies(cuda_device):
    """decode_all of a hintless manifest of 257 blocks: K6 once per 256
    blocks; the stream's words sent once, each launch's start_w, bit0 and
    avail by one copy and its rows and status back by one, each through
    page-locked memory.  The statics go to the card at the first call,
    made before the count."""
    data = corpus(257, seed=64)
    s, m = M.compress_with_manifest(data, level=2, hints=False,
                                    device=cuda_device)
    assert M.decode_all(s, m, device=cuda_device) == data
    metrics.reset()
    assert M.decode_all(s, m, device=cuda_device) == data
    c = metrics.snapshot()["counts"]
    assert {k: v for k, v in c.items() if k.startswith("kernel.")} == {
        "kernel.K6": 2}
    assert c["copy.h2d"] == 3 and c["copy.d2h"] == 2
    assert c["copy.pinned"] == 5
    words = 4 * (-(-len(s) // 4) + BI.IN_W + 8)
    assert c["copy.h2d_bytes"] == words + 12 * 257
    assert c["copy.d2h_bytes"] == 4 * 257 * (BI.OUT_W + 3)
    assert c["copy.pinned_bytes"] == c["copy.h2d_bytes"] + c[
        "copy.d2h_bytes"]
    assert c["decode.path.pallas_scalar"] == 1
    assert "decode.blocks_fallback" not in c


def test_hintless_outputs_own_their_bytes(cuda_device):
    """Two hintless manifests of the same shape decoded back to back:
    the second call reuses the first's page-locked rows, and the first
    output, and the rows inflate_blocks returned for it, are unchanged."""
    a, b = corpus(3, seed=65), corpus(3, seed=66)
    sa, ma = M.compress_with_manifest(a, level=2, hints=False,
                                      device=cuda_device)
    sb, mb = M.compress_with_manifest(b, level=2, hints=False,
                                      device=cuda_device)
    out_a = M.decode_all(sa, ma, device=cuda_device)
    rows_a = BI.inflate_blocks(sa, [x[0] for x in ma.blocks],
                               device=cuda_device)[0]
    want_rows = rows_a.copy()
    for _ in range(3):
        out_b = M.decode_all(sb, mb, device=cuda_device)
        BI.inflate_blocks(sb, [x[0] for x in mb.blocks], device=cuda_device)
    assert type(out_a) is bytes and type(out_b) is bytes
    assert out_a == a and out_b == b
    assert (rows_a == want_rows).all()


def test_pinned_copies_on_k6s_path_alone(cuda_device):
    """A hintless decode_range stages its copies through page-locked
    memory (stream, windows, rows back); a hinted one, on the wavefront,
    counts none."""
    data = corpus(4, seed=67)
    lo, hi = 1000, 70000
    hs, hm = M.compress_with_manifest(data, level=2, hints=False,
                                      device=cuda_device)
    ws, wm = M.compress_with_manifest(data, level=2, device=cuda_device)
    for s, m in ((hs, hm), (ws, wm)):
        assert M.decode_range(s, m, lo, hi, device=cuda_device) == data[
            lo:hi]
    metrics.reset()
    assert M.decode_range(hs, hm, lo, hi, device=cuda_device) == data[lo:hi]
    c = metrics.snapshot()["counts"]
    assert c["kernel.K6"] == 1 and c["copy.pinned"] == 3
    metrics.reset()
    assert M.decode_range(ws, wm, lo, hi, device=cuda_device) == data[lo:hi]
    c = metrics.snapshot()["counts"]
    assert c["decode.path.wave"] == 1 and c["copy.h2d"] >= 1
    assert "copy.pinned" not in c and "copy.pinned_bytes" not in c


def test_spans_record_the_host_s_waits_on_the_card(cuda_device):
    """Under recording(sync=True): a hintless decode_all's K6 is waited
    for by the recorder at the end of decode.block_inflate (sync_s) and
    its pinned copy back by sync_stream in decode.to_host (wait_s); a
    device decode_range's stages are waited for by the recorder and its
    copies by the program; each within its span's self time."""
    data = corpus(257, seed=68)
    lo, hi = 5000, 200000
    hs, hm = M.compress_with_manifest(data, level=2, hints=False,
                                      device=cuda_device)
    ws, wm = M.compress_with_manifest(data, level=2, device=cuda_device)
    assert M.decode_all(hs, hm, device=cuda_device) == data
    assert M.decode_range(ws, wm, lo, hi, device=cuda_device) == data[lo:hi]
    metrics.reset()
    try:
        with metrics.recording(sync=True):
            assert M.decode_all(hs, hm, device=cuda_device) == data
            hint = metrics.snapshot()["spans"]
            metrics.reset()
            assert M.decode_range(ws, wm, lo, hi,
                                  device=cuda_device) == data[lo:hi]
            spans = metrics.snapshot()["spans"]
    finally:
        metrics.reset()
    k6, back = hint["decode.block_inflate"], hint["decode.to_host"]
    assert 0 < k6["sync_s"] <= k6["self_s"]
    assert 0 < back["wait_s"] <= back["self_s"]
    stages = spans["decode.stages"]
    assert 0 < stages["sync_s"] < stages["self_s"]
    for name in ("decode.to_device", "decode.to_host"):
        assert 0 < spans[name]["wait_s"] <= spans[name]["self_s"]
    for v in list(hint.values()) + list(spans.values()):
        assert v["wait_s"] >= 0 and v["sync_s"] >= 0
        assert v["wait_s"] + v["sync_s"] <= v["self_s"] + 1e-6


def test_range_reads_of_the_cell_on_the_card(cuda_device):
    """decode_range(device=cuda) on the logs-l3-range cell's windows (two
    2 MiB chunks, the cell's 15-minute and 1-hour windows): each read is
    the chunk's bytes and the plain reference's, no block on the host,
    one wavefront decode a read (one K4 fill and one K11 a span bucket,
    so at least one a read), and the range counters agree with the
    manifest; a K6 read of the same chunk at level 2 without hints
    too."""
    from codecbench import harness
    from codecbench.reference import range as reference

    run = harness.Run(harness.load_cell("logs-l3-range.read"), 2 ** 31 + 26,
                      cuda_device, chunk_bytes=2 << 20, pool=2)
    try:
        run.warm()
        metrics.reset()
        ops = run.loop(1.0)
        c = metrics.snapshot()["counts"]
        checks = run.judge(ops)
        assert all(v == 0 for v, _ in checks.values()), checks
        assert all(o.note is None for o in ops)
        assert c["decode.path.wave"] == len(ops)
        assert c["kernel.K4"] >= len(ops) and c["kernel.K11"] >= len(ops)
        assert "kernel.K6" not in c
        assert "decode.blocks_fallback" not in c
        held = [o for o in ops if o.out is not None]
        for o in held[:4]:
            inp = run.inputs[o.index]
            start, end, out = o.out
            assert out == reference.decode_range(inp.stream, inp.man.blocks,
                                                 start, end)
        assert c["decode.range_bytes_returned"] == sum(o.size for o in ops)
        chunk = run.chunks[0]
        s, m = M.compress_with_manifest(chunk, level=2, hints=False,
                                        device=cuda_device)
        metrics.reset()
        lo, hi = run.inputs[0].lo[0], run.inputs[0].hi[0]
        assert M.decode_range(s, m, lo, hi, device=cuda_device) == chunk[
            lo:hi]
        c = metrics.snapshot()["counts"]
        assert c["kernel.K6"] == 1 and c["decode.path.pallas_scalar"] == 1
        assert c["decode.range_blocks"] == len(m.blocks_for_range(lo, hi))
    finally:
        run.close()


def test_k7_kernel_matches_plain(cuda_device):
    """Random 0-48-bit packets at every bit phase, one block full to
    NPK, one empty, and the packet lists of a real level-3 encode; then
    every edge case of pack_case against the plain version and the torch
    form of the design, pack_blocks_tiles, and operands that start off a
    16-byte line."""
    rng = np.random.default_rng(9)
    B = 4
    counts = np.array([PK.NPK, 0, 5000, 33000], np.int32)
    # mostly short packets, a tenth of 17-48 bits: within OUTW words
    width = np.where(rng.random((B, PK.NPK)) < 0.1,
                     rng.integers(17, 49, (B, PK.NPK)),
                     rng.integers(0, 6, (B, PK.NPK)))
    off = (np.cumsum(width, 1) - width).astype(np.int32)
    val = rng.integers(0, 1 << 62, (B, PK.NPK), dtype=np.int64)
    val &= (np.int64(1) << width.astype(np.int64)) - 1
    lo = (val & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    hi = (val >> 32).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda_device)
            for x in (counts, off, lo, hi)]
    got = PK.pack_blocks_kernel(*args)
    want = PK.pack_blocks_plain(*args)
    torch.cuda.synchronize()
    assert_same(got, want, "K7 random packets")

    data = np.frombuffer(corpus(2, seed=35), np.uint8).reshape(2, 32768)
    blocks = torch.from_numpy(data.copy()).to(cuda_device)
    blens = torch.full((2,), 32768, dtype=torch.int32, device=cuda_device)
    plans = E.batch_plan(blocks, blens, 3)
    live = torch.ones(2, dtype=torch.bool, device=cuda_device)
    choice, pad, _, _ = E.choose_blocks(plans["fixed_bits"],
                                        plans["dyn_bits"], blens, live, 3, 0)
    bfinal = torch.arange(2, device=cuda_device) == 1
    off, lo, hi, counts, _, _ = E.build_packets(blocks, blens, plans,
                                                choice, pad, bfinal)
    got = PK.pack_blocks_kernel(counts, off, lo, hi)
    want = PK.pack_blocks_plain(counts, off, lo, hi)
    torch.cuda.synchronize()
    assert_same(got, want, "K7 level-3 packets")
    assert_same(got, PK.pack_blocks_tiles(counts, off, lo, hi),
                "K7 level-3 packets vs tiles")

    for case in PACK_CASES:
        args = [torch.from_numpy(x).to(cuda_device) for x in pack_case(case)]
        got = PK.pack_blocks_kernel(*args)
        torch.cuda.synchronize()
        assert_same(got, PK.pack_blocks_plain(*args), f"K7 {case}")
        assert_same(got, PK.pack_blocks_tiles(*args), f"K7 {case} vs tiles")
    # off, lo and hi as views one int32 past a 16-byte line
    flat = [torch.cat([torch.zeros(1, dtype=torch.int32, device=cuda_device),
                       x.reshape(-1)]) for x in args[1:]]
    views = [f[1:].view(x.shape) for f, x in zip(flat, args[1:])]
    assert views[0].data_ptr() % 16
    got = PK.pack_blocks_kernel(args[0], *views)
    torch.cuda.synchronize()
    assert_same(got, PK.pack_blocks_plain(*args), "K7 misaligned views")


def test_k9_kernel_matches_plain(cuda_device):
    """K9 against greedy_parse_plain and the torch form of its design,
    greedy_parse_walk, with zero tolerance: every parse_case (ragged
    blen, lengths past the tile and blen, an all-zero row, a match at
    every position, find_matches of the mixed corpus at levels 2 and 3)
    at tiles 512 and 2048, lazy and not; then a length view that starts
    off a 16-byte line."""
    for case in PARSE_CASES:
        length, blen = parse_case(case, cuda_device)
        length = torch.from_numpy(length).to(cuda_device)
        blen = torch.from_numpy(blen).to(cuda_device)
        for tile in PARSE_TILES:
            for lazy in (True, False):
                got = LZ.greedy_parse_kernel(length, blen, lazy, tile)
                want = LZ.greedy_parse_plain(length, blen, lazy, tile)
                walk = LZ.greedy_parse_walk(length, blen, lazy, tile)
                torch.cuda.synchronize()
                what = f"K9 {case} tile {tile} lazy {lazy}"
                assert got[0].dtype == torch.bool, what
                for g, w, v in zip(got, want, walk):
                    assert_same(g, w, what)
                    assert_same(g, v, what + " vs walk")
    flat = torch.cat([torch.zeros(1, dtype=torch.int32, device=cuda_device),
                      length.reshape(-1)])
    view = flat[1:].view(length.shape)
    assert view.data_ptr() % 16
    got = LZ.greedy_parse_kernel(view, blen)
    torch.cuda.synchronize()
    for g, w in zip(got, LZ.greedy_parse_plain(length, blen)):
        assert_same(g, w, "K9 misaligned view")
    with pytest.raises(ValueError):
        LZ.greedy_parse_kernel(length, blen, tile=96 * 1024)


def test_k9_once_per_tokenize_block(cuda_device, monkeypatch):
    """Every tokenize_block on the card launches K9 exactly once: the
    manifest encode at levels 1-3 (one batch), compress in segments of
    64 blocks, with stats (a second planning pass) and compress_many."""
    calls = []
    tokenize = E.tokenize_block

    def counted(*args, **kw):
        calls.append(args[2] if len(args) > 2 else kw["level"])
        return tokenize(*args, **kw)

    monkeypatch.setattr(E, "tokenize_block", counted)
    data = corpus(65, seed=36)[:64 * 32768 + 5000]
    metrics.reset()
    for level in (1, 2, 3):
        s, m = M.compress_with_manifest(data[:200000], level=level,
                                        device=cuda_device)
        assert zlib.decompress(s, -15) == data[:200000]
    assert zlib.decompress(D.compress(data, 2, device=cuda_device),
                           -15) == data
    D.compress(data[:100000], 2, stats={}, device=cuda_device)
    D.compress_many([data[:70000], data[-40000:]], 2, device=cuda_device)
    torch.cuda.synchronize()
    assert len(calls) >= 7 and {1, 2, 3} <= set(calls)
    assert metrics.snapshot()["counts"]["kernel.K9"] == len(calls)


def _on(x, dev):
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def test_k10_kernel_matches_plain(cuda_device, monkeypatch):
    """K10 against the plain lag search with zero tolerance: every hash
    pass of find_matches on search_blocks (the mixed corpus, log lines
    at the 128-byte cap and up to the block's end, an all-zero block,
    blen 0-4, 131, BLOCK - 1 and BLOCK) at level 2's settings and at
    level 3's (the 3-byte chain and the 8- and 16-byte grams, a far cut
    of 256 or 4096 by block), _tier_pass on the card against the same
    pass on the CPU; then the whole find_matches on the card against
    the CPU, and a block view that starts off a word."""
    block, blen = (torch.from_numpy(a) for a in search_blocks())
    cut = torch.from_numpy(
        np.where(np.arange(len(blen)) % 2, 4096, 256).astype(np.int32))
    levels = {2: (E.L2_CANDS, E.L2_WIN_WORDS, (), E.L2_TOOFAR3),
              3: (E.L3_CANDS, E.L3_WIN_WORDS, E.L3_TIERS, cut)}
    tier_pass = LZ._tier_pass
    passes = []

    def kept(*args):
        out = tier_pass(*args)
        if not args[0].is_cuda:
            passes.append((args, out))
        return out

    monkeypatch.setattr(LZ, "_tier_pass", kept)
    pos = torch.arange(block.shape[1], dtype=torch.int32)[None, :]
    for level, (K, W, tiers, tf) in levels.items():
        passes.clear()
        want = LZ.find_matches(block, blen, K, win_words=W, tiers=tiers,
                               toofar3=tf)
        got = LZ.find_matches(block.to(cuda_device), blen.to(cuda_device),
                              K, win_words=W, tiers=tiers,
                              toofar3=_on(tf, cuda_device))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert_same(g, w, f"find_matches level {level}")
        assert len(passes) == 1 + len(tiers)
        for p, (args, (wl, wd)) in enumerate(passes):
            gl, gd = tier_pass(*(_on(a, cuda_device) for a in args))
            torch.cuda.synchronize()
            what = f"K10 level {level} pass {p}"
            assert_same(gl, wl, what + " length")
            assert_same(gd, wd, what + " dist")
            assert (wl == 4 * W).any(), what + ": no match at the cap"
            end = (wl > 0) & (wl < 4 * W) & (wl == blen[:, None] - pos)
            assert end.any(), what + ": no match ends at blen"
    # keys of 8 deep buckets, one position in ten where no match starts
    rng = np.random.default_rng(3)
    h = rng.integers(0, 8, block.shape)
    key = np.where(rng.random(block.shape) < 0.9, (h << 15) | pos.numpy(),
                   (1 << 30) + pos.numpy())
    skey = torch.from_numpy(np.sort(key, 1).astype(np.int32)).to(cuda_device)
    kblock = block.to(cuda_device)
    flat = torch.cat([torch.zeros(1, dtype=torch.uint8, device=cuda_device),
                      kblock.reshape(-1)])
    view = flat[1:].view(kblock.shape)
    assert view.data_ptr() % 4
    for args in ((view, skey, blen, 4, 8, 256), (kblock, skey, blen, 0, 8,
                                                  256)):
        got = LZ.lag_search_kernel(*(_on(a, cuda_device) for a in args))
        torch.cuda.synchronize()
        want = LZ.lag_search_plain(kblock, *(_on(a, cuda_device)
                                             for a in args[1:]))
        for g, w in zip(got, want):
            assert_same(g, w, f"K10 K={args[3]}")
    with pytest.raises(ValueError):
        LZ.lag_search_kernel(kblock[:, :-2], skey[:, :-2],
                             blen.to(cuda_device), 4, 8, 256)


def test_k10_once_per_pass(cuda_device, monkeypatch):
    """Every hash pass of find_matches on the card launches K10 once (3 a
    level-3 tokenize_block, 1 a level-2 one) and never the plain lag
    search; lz77.pairs counts B x n x depth a pass as before."""
    calls = []
    tokenize = E.tokenize_block

    def counted(*args, **kw):
        level = args[2] if len(args) > 2 else kw["level"]
        calls.append((level, args[0].numel()))
        return tokenize(*args, **kw)

    def plain(*args, **kw):
        raise AssertionError("the plain lag search ran on the card")

    monkeypatch.setattr(E, "tokenize_block", counted)
    monkeypatch.setattr(LZ, "lag_search_plain", plain)
    monkeypatch.setattr(LZ, "_lag_lengths", plain)
    data = corpus(65, seed=37)[:64 * 32768 + 5000]
    metrics.reset()
    for level in (1, 2, 3):
        s, m = M.compress_with_manifest(data[:200000], level=level,
                                        device=cuda_device)
        assert zlib.decompress(s, -15) == data[:200000]
    assert zlib.decompress(D.compress(data, 2, device=cuda_device),
                           -15) == data
    D.compress_many([data[:70000], data[-40000:]], 2, device=cuda_device)
    torch.cuda.synchronize()
    passes = {1: 0, 2: 1, 3: 1 + len(E.L3_TIERS)}
    depth = {1: 0, 2: E.L2_CANDS, 3: E.L3_CANDS}
    assert {1, 2, 3} <= {lv for lv, _ in calls}
    counts = metrics.snapshot()["counts"]
    assert counts["kernel.K10"] == sum(passes[lv] for lv, _ in calls)
    assert counts["lz77.pairs"] == sum(passes[lv] * depth[lv] * npos
                                       for lv, npos in calls)


def _glue_operands_of_a_decode(dev, monkeypatch, name: str) -> list:
    """The operands (on the CPU) of every `name`_kernel call of a forced
    decode of a zlib-6 stream on the card: the mixed corpus, whose
    repeated quarter gives chains of matches at one distance."""
    data = corpus(8, seed=39)
    kernel = getattr(W, name + "_kernel")
    ops = []

    def kept(*args):
        ops.append(tuple(a.cpu() for a in args))
        return kernel(*args)

    monkeypatch.setattr(W, name + "_kernel", kept)
    out = D.decompress(deflate_raw(data, 6), len(data), device=dev,
                       force_device=True)
    monkeypatch.setattr(W, name + "_kernel", kernel)
    assert out == data and ops
    return ops


def test_k11_kernel_matches_plain(cuda_device, monkeypatch):
    """K11 against resolve_litval_plain with zero tolerance, on the card
    and on the CPU: every (len_, r_rel) of 0..15 x 0..511 and negative
    ranks over masks with bit 31 set in some words and empty words
    (litval_case), the same lanes as [B, 4, n/4], and the stage-E
    operands of every wave_decode of a forced zlib-6 decode."""
    len_, r_rel, mask = (torch.from_numpy(a) for a in litval_case())
    B, n = len_.shape
    ops = [(len_, r_rel, mask),
           (len_.reshape(B, 4, n // 4), r_rel.reshape(B, 4, n // 4), mask)]
    ops += _glue_operands_of_a_decode(cuda_device, monkeypatch,
                                      "resolve_litval")
    for i, args in enumerate(ops):
        on = [a.to(cuda_device) for a in args]
        got = W.resolve_litval_kernel(*on)
        card = W.resolve_litval_plain(*on)
        torch.cuda.synchronize()
        assert_same(got, card, f"K11 operands {i} vs the card's plain")
        assert_same(got, W.resolve_litval_plain(*args),
                    f"K11 operands {i} vs the CPU's plain")


def test_k12_kernel_matches_plain(cuda_device, monkeypatch):
    """K12 against merge_match_runs_plain with zero tolerance over the
    whole [B, NM] (fill included) and nmatch, on the card (its route on
    K3) and on the CPU: merge_case's rows (chains across 256-record
    tiles, an empty and a full row, distance 0, holes, merged lengths
    past bit 31, random words) and the records of every wave_decode of
    a forced zlib-6 decode."""
    ops = [tuple(torch.from_numpy(a) for a in merge_case())]
    ops += _glue_operands_of_a_decode(cuda_device, monkeypatch,
                                      "merge_match_runs")
    for i, args in enumerate(ops):
        on = [a.to(cuda_device) for a in args]
        got = W.merge_match_runs_kernel(*on)
        card = W.merge_match_runs_plain(*on)
        torch.cuda.synchronize()
        for g, c, w, what in zip(got, card, W.merge_match_runs_plain(*args),
                                 ("rec0", "rec1", "nmatch")):
            assert_same(g, c, f"K12 operands {i} {what} vs the card's plain")
            assert_same(g, w, f"K12 operands {i} {what} vs the CPU's plain")
    assert int(ops[-1][0].ge(0).sum()) > int(got[2].sum())   # runs merged


def test_k11_k12_once_per_wave_decode(cuda_device, monkeypatch):
    """Every wave_decode on the card launches K11 once and K12 once and
    never runs their plain versions: a forced decode of a zlib-6 stream
    of 72 blocks (two groups of virtual blocks) and a hinted decode_all
    (one wave_decode a bucket)."""
    calls = []
    wave_decode = W.wave_decode

    def counted(*args, **kw):
        calls.append(args[0].shape[0])
        return wave_decode(*args, **kw)

    def plain(*args, **kw):
        raise AssertionError("a plain C-F glue version ran on the card")

    monkeypatch.setattr(W, "wave_decode", counted)
    monkeypatch.setattr(W, "resolve_litval_plain", plain)
    monkeypatch.setattr(W, "merge_match_runs_plain", plain)
    data = corpus(72, seed=38)
    raw = deflate_raw(data, 6)
    s, m = M.compress_with_manifest(data[:300000], level=2,
                                    device=cuda_device)
    metrics.reset()
    assert D.decompress(raw, len(data), device=cuda_device,
                        force_device=True) == data
    n_forced = len(calls)
    assert M.decode_all(s, m, device=cuda_device) == data[:300000]
    torch.cuda.synchronize()
    counts = metrics.snapshot()["counts"]
    assert n_forced >= 2 and len(calls) > n_forced
    assert counts["kernel.K11"] == counts["kernel.K12"] == len(calls)


def test_k8_kernel_matches_plain(cuda_device):
    data = corpus(4, seed=21)
    stream, man = M.compress_with_manifest(data, level=3, device="cpu")
    offs = [b[0] for b in man.blocks]
    md = W.parse_headers_host(stream, offs)
    huff = [i for i in range(len(offs)) if md["btype"][i] != 0]
    for W64 in (512, 4224):
        nw = torch.from_numpy(W.prepare_windows(
            stream, md["data_start"][huff], W64)).to(cuda_device)
        mds = torch.stack([torch.from_numpy(np.asarray(md[k])[huff])
                           for k in W.MD_KEYS], 1).to(cuda_device)
        got = WS.decode_positions_kernel(nw, mds, W64)
        want = WS.decode_positions_plain(nw, mds, W64)
        torch.cuda.synchronize()
        assert_same(got[0], want[0], f"A0 W64={W64}")
        assert_same(got[1], want[1], f"P1 W64={W64}")


def _stagea_cases(dev):
    """Stage-A operands on the card (windows, hints, md rows [B, 7, 16]):
    the level-3 stream of corpus(4) at W64 = 512 with its manifest's
    hints, random words under random codes, and codes up to 15 bits long
    under words that reach them (most peeks miss the tables)."""
    data = corpus(4, seed=21)
    stream, man = M.compress_with_manifest(data, level=3, device="cpu")
    offs = [b[0] for b in man.blocks]
    md = W.parse_headers_host(stream, offs)
    huff = [i for i in range(len(offs)) if md["btype"][i] != 0]
    W64 = 512
    nw = W.prepare_windows(stream, md["data_start"][huff], W64)
    hints = man.hint_array()[huff][:, :W64]
    hs = np.full((len(huff), W64), W.HINT_NONE, np.int32)
    hs[:, :hints.shape[1]] = hints
    rng = np.random.default_rng(12)
    out = [(nw, hs, {k: np.asarray(md[k])[huff] for k in W.MD_KEYS}),
           random_code_case(rng, 4, W64), long_code_case(rng, 4, W64)]
    return [(torch.from_numpy(nw).to(dev), torch.from_numpy(hs).to(dev),
             W.stack_md({k: torch.from_numpy(np.ascontiguousarray(
                 v, np.int32)) for k, v in m.items()}).to(dev), W64)
            for nw, hs, m in out]


def test_k8_kernel_matches_lut(cuda_device):
    """K8 against the torch form of its design and its plain version,
    the exact decode behind the tables' SLOW entries included."""
    for i, (nw, _, mds, W64) in enumerate(_stagea_cases(cuda_device)):
        got = WS.decode_positions_kernel(nw, mds, W64)
        torch.cuda.synchronize()
        for want, name in ((WS.decode_positions_lut(nw, mds, W64), "lut"),
                           (WS.decode_positions_plain(nw, mds, W64),
                            "plain")):
            assert_same(got[0], want[0], f"A0 vs {name}, case {i}")
            assert_same(got[1], want[1], f"P1 vs {name}, case {i}")


def test_k2_kernel_matches_lut(cuda_device):
    """K2 against the torch form of its design and its plain version,
    with the stop bit as its own pointer (on each block's chain) and as
    none, at 15 rounds and at maxl/maxd 12/13; and the tables its build
    pass writes against build_tables."""
    for i, (nw, hs, mds, W64) in enumerate(_stagea_cases(cuda_device)):
        sums = WS.decode_mark_plain(nw, hs, mds, W64)[2]
        w = torch.argmax((sums[:, 5] >= 2).to(torch.int32), 1)
        b = torch.arange(nw.shape[0], device=cuda_device)
        stop = (64 * w + hs[b, w]).to(torch.int32)
        for st, ml, mdx in ((None, 15, 15), (stop, 15, 15), (None, 12, 13),
                            (stop, 12, 13)):
            got = WS.decode_mark_kernel(nw, hs, mds, W64, st, ml, mdx)
            torch.cuda.synchronize()
            for want, name in (
                    (WS.decode_mark_lut(nw, hs, mds, W64, st, ml, mdx),
                     "lut"),
                    (WS.decode_mark_plain(nw, hs, mds, W64, st, ml, mdx),
                     "plain")):
                for g, x, k in zip(got, want, ("A0c", "P1c", "sums")):
                    assert_same(g, x, f"{k} vs {name}, case {i}, "
                                      f"stop {st is not None}, {ml}/{mdx}")
            tables = torch.empty((nw.shape[0], WS.TABLE_WORDS),
                                 dtype=torch.int32, device=cuda_device)
            WS.mark_launch(nw, hs, mds, st, *got, tables, W64, ml, mdx)
            torch.cuda.synchronize()
            assert_same(tables, torch.cat(WS.build_tables(
                mds, WS.KL, WS.KD, ml, mdx), 1), f"tables, case {i}")


def test_level3_kernel_pack_and_split_decode_on_card(cuda_device,
                                                     monkeypatch):
    """Level 3's stage C through K7's route (emit_block_packed: K3, then
    K7) on the card equals emit_block's words on the card and on the
    CPU, and the split stage-A decode round-trips a level-3 stream."""
    data = corpus(3, seed=36)[:3 * 32768 - 501]
    buf = np.frombuffer(data, np.uint8)
    blocks = np.zeros((3, 32768), np.uint8)
    blens = np.zeros(3, np.int32)
    for b in range(3):
        c = buf[b * 32768:(b + 1) * 32768]
        blocks[b, :len(c)] = c
        blens[b] = len(c)

    def stage_c_args(dev):
        tb, tn = torch.from_numpy(blocks).to(dev), torch.from_numpy(
            blens).to(dev)
        plans = E.batch_plan(tb, tn, 3)
        choice, pad, _, _ = E.choose_blocks(
            plans["fixed_bits"], plans["dyn_bits"], tn,
            torch.ones(3, dtype=torch.bool, device=dev), 3)
        return tb, tn, plans, choice, pad, torch.arange(3, device=dev) == 2

    want = E.emit_block(*stage_c_args("cpu"))
    card = stage_c_args(cuda_device)
    metrics.reset()
    got = E.emit_block_packed(*card)
    counts = metrics.snapshot()["counts"]
    assert counts["kernel.K3"] == 1 and counts["kernel.K7"] == 1, counts
    assert_same(got, E.emit_block(*card), "K7 route vs emit_block, card")
    assert_same(got, want, "K7 route on the card vs emit_block, CPU")
    s, m = M.compress_with_manifest(data, level=3, device=cuda_device)
    assert zlib.decompress(s, -15) == data
    monkeypatch.setenv("DT_STAGEAB_PALLAS", "0")
    assert M.decode_all(s, m, device=cuda_device) == data


def test_speculative_decoder_on_card_equals_cpu(cuda_device):
    """decode_stream on the card against the CPU (every output, in
    full), and the inputs only the speculative decoder serves through
    decompress on the card."""
    text = bytes(np.random.default_rng(6).integers(97, 117, 30000,
                                                    dtype=np.uint8))
    corrupt = bytearray(deflate_raw(text, 9))
    corrupt[5] ^= 0xFF
    for raw in (deflate_raw(text, 1), deflate_raw(text, 9),
                deflate_raw(b"\0\1\2" * 5000, 0),
                deflate_raw(b"a" * 100000, 6), bytes(corrupt)):
        w, nbits = BP.bytes_to_words(raw)
        w = torch.from_numpy(w.view(np.int32))
        got = DEC.decode_stream(w.to(cuda_device), nbits, IS.SPAN, 1 << 18, 8)
        want = DEC.decode_stream(w, nbits, IS.SPAN, 1 << 18, 8)
        for g, x, name in zip(got, want, ("out", "total", "nblocks",
                                           "error")):
            assert_same(g, x, name)
    for name, raw, size, data in speculative_cases():
        st = {}
        if data is None:
            with pytest.raises(D.InflateError):
                D.decompress(raw, size, device=cuda_device,
                             force_device=True)
        else:
            assert D.decompress(raw, size, device=cuda_device,
                                force_device=True, stats=st) == data, name
            assert st["device_path"] == "speculative", name


def test_packed_decode_on_card_equals_cpu(cuda_device):
    """The single-transfer bucketed decode (inflate_wave_device) on the
    card gives the CPU's words, produced counts and error flags."""
    data = corpus(8, seed=44)
    stream, man = M.compress_with_manifest(data, level=2, device="cpu")
    args = (stream, [b[0] for b in man.blocks], [b[2] for b in man.blocks],
            man.hint_array())
    got = WD.inflate_wave_device(*args, device=cuda_device)
    want = WD.inflate_wave_device(*args, device="cpu")
    for g, w, name in zip(got, want, ("words", "produced", "err")):
        assert np.array_equal(g, w), name
    assert not got[2].any()


def test_mesh_world_of_one_on_card_equals_cpu(cuda_device):
    """compress_mesh and both decompress_mesh routes on a world of one
    over NCCL give the CPU's stream and the input back."""
    import torch.distributed as dist

    from deflate_tpu_torch.parallel import mesh as PM

    data = corpus(6, seed=35)[:6 * 32768 - 999]
    s_cpu, m_cpu = M.compress_with_manifest(data, level=2, device="cpu")
    h_cpu, hm_cpu = M.compress_with_manifest(data, level=2, hints=False,
                                             device="cpu")
    mesh = PM.make_mesh(device="cuda")
    try:
        assert mesh.size() == 1 and dist.get_backend() == "nccl"
        assert PM.compress_mesh(data, 2, mesh) == s_cpu
        assert PM.decompress_mesh(s_cpu, m_cpu, mesh) == data
        assert PM.decompress_mesh(h_cpu, hm_cpu, mesh) == data
        with pytest.raises(ValueError):
            PM.decompress_mesh(s_cpu[:len(s_cpu) // 2] + bytes(
                len(s_cpu) - len(s_cpu) // 2), m_cpu, mesh)
    finally:
        dist.destroy_process_group()
