"""Port vs reference, the table-driven stage-A decode of kernels K8 and
K2 in its torch form: wave_stagea.decode_positions_lut against K8's
plain version and the reference's decode_positions_pallas (interpret
mode), and wave_stagea.decode_mark_lut against K2's plain version and
decode_mark_pallas (interpret mode), all with zero tolerance.

Inputs: the level-2 and level-3 streams of corpus(4) (windows cut to
W64 = 256), a fixed-Huffman block, random words under random complete
codes (one with an incomplete one-code distance tree), a code whose
longest litlen and distance codes are 15 bits under words that are
mostly ones (so the tables' SLOW entries, and the exact decode behind
them, are hit), and for K2 the CCAP-overflow stream (a 1-bit literal
code, 64 starts a chunk)."""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deflate_tpu.ops.wave_stagea import (decode_mark_pallas,
                                         decode_positions_pallas)
from deflate_tpu_torch.ops import wave as W
from deflate_tpu_torch.ops import wave_stagea as WS
from deflate_tpu_torch.runtime import manifest as M
from test_ccap_overflow import _craft_stream
from torch_helpers import (assert_same, corpus, long_code_case,
                           random_code_case)

B, W64 = 3, 256              # every case's shape: one compile of each
                             # reference kernel and option set


def _stream_case(stream: bytes, offs, hints=None):
    """B Huffman blocks of a stream (its first ones, repeated as needed):
    windows cut to W64 chunks, hints (the manifest's, or the host
    walk's), md rows."""
    md = W.parse_headers_host(stream, offs)
    huff = [i for i in range(len(offs)) if md["btype"][i] != 0]
    huff = (huff * B)[:B]
    if hints is None:
        hints, _ = W.hints_from_walk_host(stream, offs)
    nw = W.prepare_windows(stream, md["data_start"][huff], W64)
    hs = np.full((B, W64), W.HINT_NONE, np.int32)
    n = min(W64, hints.shape[1])
    hs[:, :n] = np.asarray(hints)[huff][:, :n]
    return nw, hs, {k: np.ascontiguousarray(md[k][huff], np.int32)
                    for k in W.MD_KEYS}


@pytest.fixture(scope="module")
def cases():
    out = {}
    data = corpus(4)
    for level in (2, 3):
        s, m = M.compress_with_manifest(data, level=level, device="cpu")
        out[f"level{level}"] = _stream_case(s, [b[0] for b in m.blocks],
                                            m.hint_array())
    rng = np.random.default_rng(71)
    text = bytes(rng.integers(97, 105, 6000, dtype=np.uint8)) * 2
    c = zlib.compressobj(9, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    out["fixed"] = _stream_case(c.compress(text) + c.flush(), [0])
    out["random"] = random_code_case(rng, B, W64)
    out["long15"] = long_code_case(rng, B, W64)
    out["ccap"] = _stream_case(_craft_stream()[0], [0])
    return out


def _jmd(md):
    return {k: jnp.asarray(v) for k, v in md.items()}


def _tmd(md):
    return W.stack_md({k: torch.from_numpy(v) for k, v in md.items()})


POS_CASES = ["level2", "level3", "fixed", "random", "long15"]


@pytest.mark.parametrize("kl,kd", [(10, 10), (12, 8)], ids=["kl10", "kl12"])
@pytest.mark.parametrize("case", POS_CASES)
def test_decode_positions_lut(cases, case, kl, kd):
    nw, _, md = cases[case]
    nwt, mds = torch.from_numpy(nw), _tmd(md)
    got = WS.decode_positions_lut(nwt, mds, W64, kl, kd)
    plain = WS.decode_positions_plain(nwt, mds, W64)
    ja, jp = decode_positions_pallas(jnp.asarray(nw), _jmd(md), W64,
                                     interpret=True)
    for g, p, j, name in zip(got, plain, (ja, jp), ("A0", "P1")):
        assert_same(g, p, f"{name} vs plain")
        assert_same(g, j, f"{name} vs decode_positions_pallas")
    if case == "random":                # the one-code distance tree: no
        dlut = WS.build_tables(mds, kl, kd)[1]   # peek is left SLOW
        assert not bool((dlut[-1] == WS.SLOW).any())
    if case == "long15":                # the exact decode behind SLOW ran
        lut, dlut = WS.build_tables(mds, kl, kd)
        PK, _ = W.build_peeks(nwt, W64)
        e = torch.gather(lut, 1, (PK.reshape(len(nw), -1)
                                  & ((1 << kl) - 1)).long())
        assert int((e == WS.SLOW).sum()) > 1000
        assert bool((dlut == WS.SLOW).any())


def _stop_on_chain(nw, hs, mds):
    """Per block, the first symbol start of a chunk with two or more
    starts (a position on the chain K2 walks)."""
    _, _, sums = WS.decode_mark_plain(torch.from_numpy(nw),
                                      torch.from_numpy(hs), mds, W64)
    cnt = sums[:, 5].numpy()
    stop = np.full(len(nw), -1, np.int32)
    for b in range(len(nw)):
        ws = np.nonzero((cnt[b] >= 2) & (hs[b] < 64))[0]
        if len(ws):
            w = int(ws[len(ws) // 2])
            stop[b] = 64 * w + int(hs[b, w])
    return stop


MARK_CASES = POS_CASES + ["ccap"]


@pytest.mark.parametrize("maxl,maxd", [(15, 15), (12, 13)],
                         ids=["rounds15", "rounds12_13"])
@pytest.mark.parametrize("stop", [False, True], ids=["nostop", "stop"])
@pytest.mark.parametrize("case", MARK_CASES)
def test_decode_mark_lut(cases, case, stop, maxl, maxd):
    nw, hs, md = cases[case]
    nwt, hst, mds = torch.from_numpy(nw), torch.from_numpy(hs), _tmd(md)
    sb = _stop_on_chain(nw, hs, mds) if stop else None
    assert sb is None or (sb >= 0).all()
    sbt = None if sb is None else torch.from_numpy(sb)
    plain = WS.decode_mark_plain(nwt, hst, mds, W64, sbt, maxl, maxd)
    for kl, kd in ((10, 8), (12, 12)):
        got = WS.decode_mark_lut(nwt, hst, mds, W64, sbt, maxl, maxd, kl,
                                 kd)
        for g, p, name in zip(got, plain, ("A0c", "P1c", "sums")):
            assert_same(g, p, f"{name} vs plain, kl={kl}")
    ja, jp, js = decode_mark_pallas(
        jnp.asarray(nw), jnp.asarray(hs), _jmd(md), W64,
        None if sb is None else jnp.asarray(sb), interpret=True, maxl=maxl,
        maxd=maxd)
    A0c, P1c, sums = got
    for i, k in enumerate(WS.SUM_KEYS):
        assert_same(sums[:, i], js[k], f"{k} vs decode_mark_pallas")
    # rows past a chunk's count: leftovers in the reference, 0 here
    rows = (np.arange(W.CCAP)[None, :, None]
            < np.asarray(js["sum_cnt"])[:, None, :])
    assert_same(np.where(rows, A0c.numpy(), 0), np.where(rows, ja, 0), "A0c")
    assert_same(np.where(rows, P1c.numpy(), 0), np.where(rows, jp, 0), "P1c")
    if case == "ccap":
        assert int(sums[:, 5].max()) > W.CCAP
