"""CUDA kernels of deflate_tpu_torch against their plain versions, and
the main path on the card against the CPU.  Every test skips without an
NVIDIA GPU.  This file imports no JAX, so it also runs where JAX is
absent:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:randomly -o addopts=""
"""
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
from deflate_tpu_torch.ops import pack as PK
from deflate_tpu_torch.ops import tree
from deflate_tpu_torch.ops import wave as W
from deflate_tpu_torch.ops import wave_fill as WF
from deflate_tpu_torch.ops import wave_route as WR
from deflate_tpu_torch.ops import wave_stagea as WS
from deflate_tpu_torch.runtime import manifest as M
from torch_helpers import (NM, PACK_CASES, ROUTE_CASES,  # noqa: F401
                           assert_same, corpus, cuda_device, fill_case,
                           hist_case, long_code_case, long_match_streams,
                           monotone_instance, pack_case, random_code_case,
                           route_case)

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
    """Level 3 through pack="kernel" on the card equals the CPU's default
    backend, and the split stage-A decode round-trips it."""
    data = corpus(3, seed=36)[:3 * 32768 - 501]
    buf = np.frombuffer(data, np.uint8)
    blocks = np.zeros((3, 32768), np.uint8)
    blens = np.zeros(3, np.int32)
    for b in range(3):
        c = buf[b * 32768:(b + 1) * 32768]
        blocks[b, :len(c)] = c
        blens[b] = len(c)
    args = [torch.from_numpy(blocks), torch.from_numpy(blens),
            torch.ones(3, dtype=torch.bool)]
    want = E.encode_batch_with_hints(*args, 2, 3, 0)
    got = E.encode_batch_with_hints(*[x.to(cuda_device) for x in args], 2,
                                    3, 0, pack="kernel")
    for g, w in zip(got, want):
        assert_same(g, w)
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
