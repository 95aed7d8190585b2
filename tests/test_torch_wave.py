"""Port vs reference, wavefront decode pieces: host header parse, windows
and hint walk; kernel K2's plain version (fused stage A+B+compaction,
including a CCAP-overflow stream); K3's plain version (monotone
routing); K4's plain version (match fill) and its record packing; the
match-run merge."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deflate_tpu.ops import wave as JW
from deflate_tpu.ops import wave_fill as JWF
from deflate_tpu.ops.wave_route import route_pallas
from deflate_tpu.ops.wave_stagea import decode_mark_pallas
from deflate_tpu_torch.ops import wave as W
from deflate_tpu_torch.ops import wave_fill as WF
from deflate_tpu_torch.ops import wave_route as WR
from deflate_tpu_torch.ops import wave_stagea as WS
from deflate_tpu_torch.runtime import manifest as M
from test_ccap_overflow import _craft_stream
from torch_helpers import (assert_same, corpus, fill_case,
                           monotone_instance)


@pytest.fixture(scope="module")
def stream4():
    """A 4-block level-2 stream (text, repeats, words, stored random)."""
    data = corpus(4, seed=21)
    stream, man = M.compress_with_manifest(data, level=2, device="cpu")
    return stream, [b[0] for b in man.blocks], man


def test_host_header_parse_and_windows_match_reference(stream4):
    stream, offs, _ = stream4
    want = JW._parse_headers_host_py(stream, offs)
    got = W.parse_headers_host(stream, offs)
    assert sorted(got) == sorted(want)
    for k in want:
        assert (np.asarray(got[k]) == np.asarray(want[k])).all(), k
    for W64 in (512, 1024):
        assert (W.prepare_windows(stream, got["data_start"], W64)
                == JW.prepare_windows(stream, want["data_start"], W64)).all()
    gh, gs = W.hints_from_walk_host(stream, offs)
    wh, ws = JW.hints_from_walk_host(stream, offs)
    assert (gh == wh).all() and (gs == ws).all()


def test_encoder_hints_equal_host_walk(stream4):
    stream, offs, man = stream4
    walk, _ = W.hints_from_walk_host(stream, offs)
    harr = man.hint_array()
    for b, h in enumerate(man.hints):
        assert (harr[b, :len(h)] == walk[b, :len(h)]).all(), b


def _stage_ab_inputs(stream, offs, W64, hints=None):
    md = W.parse_headers_host(stream, offs)
    if hints is None:
        hints, _ = W.hints_from_walk_host(stream, offs)
    nw = W.prepare_windows(stream, md["data_start"], W64)
    hs = np.full((len(offs), W64), W.HINT_NONE, np.uint8)
    hs[:, :min(W64, hints.shape[1])] = hints[:, :W64]
    return nw, hs.astype(np.int32), md


def _check_k2(nw, hs, md, W64, stop=None, maxl=15, maxd=15):
    """Plain K2 vs decode_mark_pallas(interpret=True): sums identical,
    compacted rows identical below each chunk's count (rows past it are
    leftovers in the reference, zero in the port)."""
    mdj = {k: jnp.asarray(v) for k, v in md.items()
           if k.startswith(("l_", "d_"))}
    ja, jp, js = decode_mark_pallas(
        jnp.asarray(nw), jnp.asarray(hs), mdj, W64,
        None if stop is None else jnp.asarray(stop), interpret=True,
        maxl=maxl, maxd=maxd)
    mdt = {k: torch.from_numpy(np.asarray(md[k])) for k in W.MD_KEYS}
    ta, tp, ts = WS.decode_mark(
        torch.from_numpy(nw), torch.from_numpy(hs), W.stack_md(mdt), W64,
        None if stop is None else torch.from_numpy(stop), maxl, maxd)
    for k in WS.SUM_KEYS:
        assert_same(ts[k], js[k], k)
    rows = (np.arange(W.CCAP)[None, :, None]
            < np.asarray(js["sum_cnt"])[:, None, :])
    assert (np.where(rows, ta.numpy(), 0)
            == np.where(rows, np.asarray(ja), 0)).all()
    assert (np.where(rows, tp.numpy(), 0)
            == np.where(rows, np.asarray(jp), 0)).all()
    assert (ta.numpy()[~rows] == 0).all() and (tp.numpy()[~rows] == 0).all()
    return np.asarray(js["sum_cnt"])


def test_k2_plain_matches_decode_mark_pallas():
    rng = np.random.default_rng(5)
    data = (rng.integers(97, 123, 2600, dtype=np.uint8).tobytes()
            + np.tile(rng.integers(0, 256, 53, dtype=np.uint8), 40).tobytes())
    stream, man = M.compress_with_manifest(data, level=2, device="cpu")
    offs = [b[0] for b in man.blocks]
    W64 = 128
    nw, hs, md = _stage_ab_inputs(stream, offs, W64, man.hint_array())
    _check_k2(nw, hs, md, W64)
    _check_k2(nw, hs, md, W64, stop=np.array([777], np.int32))
    _check_k2(nw, hs, md, W64, maxl=12, maxd=13)


def test_k2_plain_ccap_overflow_matches_reference():
    """A 1-bit literal code puts 64 symbol starts in a chunk: ranks past
    CCAP are dropped, sum_cnt still counts them (the caller's flag)."""
    stream, _ = _craft_stream()
    W64 = 256
    nw, hs, md = _stage_ab_inputs(stream, [0], W64)
    cnt = _check_k2(nw, hs, md, W64)
    assert cnt.max() > W.CCAP


@pytest.mark.parametrize("left", [True, False], ids=["left", "right"])
def test_k3_plain_matches_route_pallas(left):
    rng = np.random.default_rng(int(left))
    B, L = 2, 2048
    pays, delta = monotone_instance(rng, B, L, left)
    rounds = 11
    (ja, jb), jd = route_pallas([jnp.asarray(p) for p in pays],
                                jnp.asarray(delta), rounds, left=left,
                                interpret=True)
    (ta, tb), td = WR.route([torch.from_numpy(p) for p in pays],
                            torch.from_numpy(delta), rounds, left=left)
    landed = np.asarray(jd) == 0
    assert ((td.numpy() == 0) == landed).all()
    assert (ta.numpy()[landed] == np.asarray(ja)[landed]).all()
    assert (tb.numpy()[landed] == np.asarray(jb)[landed]).all()
    # the port's contract: 0 payload, dout -1 wherever nothing landed
    assert (ta.numpy()[~landed] == 0).all() and (td.numpy()[~landed] == -1).all()


def test_k4_plain_matches_fill_matches_interpret():
    B = JWF.K
    lit, rec0, rec1, nmatch = fill_case(B)
    jrecs = JWF.pack_fill_recs(jnp.asarray(rec0), jnp.asarray(rec1))
    trecs = WF.pack_fill_recs(torch.from_numpy(rec0), torch.from_numpy(rec1))
    assert_same(trecs, jrecs, "packed records")
    want = JWF.fill_matches(jnp.asarray(lit), jrecs, jnp.asarray(nmatch), B,
                            interpret=True)
    got = WF.fill_matches(torch.from_numpy(lit), trecs,
                          torch.from_numpy(nmatch))
    assert_same(got, want, "filled words")


def test_merge_match_runs_matches_reference():
    rng = np.random.default_rng(3)
    B = 2
    rec0 = np.full((B, W.NM), -1, np.int32)
    rec1 = np.zeros((B, W.NM), np.int32)
    for b in range(B):
        o, m = 0, 0
        while o < 30000 and m < 3000:
            ln = int(rng.integers(3, 40))
            d = int(rng.choice([7, 7, 7, 300])) if o > 300 else 1
            rec0[b, m] = o | ((ln - 3) << 16)
            rec1[b, m] = d
            o += ln + (0 if rng.random() < 0.7 else int(rng.integers(1, 9)))
            m += 1
    j0, j1, jn = JW.merge_match_runs(jnp.asarray(rec0), jnp.asarray(rec1),
                                     True, route_pallas)
    t0, t1, tn = W.merge_match_runs(torch.from_numpy(rec0),
                                    torch.from_numpy(rec1))
    assert_same(tn, jn, "nmatch")
    for b in range(B):
        n = int(jn[b])
        assert_same(t0[b, :n], j0[b, :n], "rec0")
        assert_same(t1[b, :n], j1[b, :n], "rec1")
