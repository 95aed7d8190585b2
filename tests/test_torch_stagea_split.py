"""Port vs reference, the split stage-A route of the wavefront decode:
kernel K8's plain version (stage A at every bit position) against the
reference's Pallas kernel in interpret mode, and the port's wave_decode
with DT_STAGEAB_PALLAS=0 (K8, then the mark automaton and compaction in
torch) against the reference's default wave_decode, every output, with
and without a synthetic stop."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deflate_tpu.ops import wave as JW
from deflate_tpu.ops.wave_stagea import decode_positions_pallas
from deflate_tpu_torch.models import wave_decoder as WD
from deflate_tpu_torch.ops import wave as W
from deflate_tpu_torch.ops import wave_stagea as WS
from deflate_tpu_torch.runtime import manifest as M
from torch_helpers import assert_same, corpus

OUTS = ("litwords", "rec0", "rec1", "nmatch", "produced", "err")


def _bucket(data: bytes, W64: int):
    """One bucket of a level-2 stream's Huffman blocks at W64: windows,
    hints, expected sizes and header tables (numpy)."""
    stream, man = M.compress_with_manifest(data, level=2, device="cpu")
    prep = WD._common_prep(stream, [b[0] for b in man.blocks],
                           [b[2] for b in man.blocks], man.hint_array())
    sel = prep["hidx_all"]
    assert (prep["need"] <= W64).all()
    nw = W.prepare_windows(stream, prep["md"]["data_start"][sel], W64)
    hs = np.full((len(sel), W64), W.HINT_NONE, np.int32)
    hav = min(W64, prep["hints"].shape[1])
    hs[:, :hav] = prep["hints"][sel][:, :hav]
    md = {k: np.ascontiguousarray(prep["md"][k][sel], np.int32)
          for k in WD.MD_DEVICE_KEYS}
    return nw, hs, prep["out_sizes"][sel].astype(np.int32), md


def _mds(md):
    return W.stack_md({k: torch.from_numpy(md[k]) for k in W.MD_KEYS})


def test_k8_plain_matches_decode_positions_pallas():
    """Two blocks of text and a repeated pattern at W64 = 128."""
    rng = np.random.default_rng(6)
    text = rng.integers(97, 123, 900, dtype=np.uint8).tobytes()
    pat = np.tile(rng.integers(0, 256, 53, dtype=np.uint8), 620).tobytes()
    data = (text + pat)[:32768] + text[:500] + pat[:2000]
    nw, _, _, md = _bucket(data, 128)
    assert nw.shape == (2, 2 * 128 + 4)
    ja, jp = decode_positions_pallas(
        jnp.asarray(nw), {k: jnp.asarray(md[k]) for k in W.MD_KEYS}, 128,
        interpret=True)
    ta, tp = WS.decode_positions(torch.from_numpy(nw), _mds(md), 128)
    assert ta.shape == (2, 64, 128)
    assert_same(ta, ja, "A0")
    assert_same(tp, jp, "P1")


@pytest.fixture(scope="module")
def split_bucket():
    """Two blocks in one W64 = 512 bucket (text then repeats; repeats
    then words), and a stop bit on block 0's symbol chain (its 300th
    symbol start)."""
    c = corpus(2, seed=44)
    data = ((c[:3000] + c[16384:32768] * 2)[:32768]
            + c[16384:21384] + c[32768:34768])
    nw, hs, sizes, md = _bucket(data, 512)
    assert nw.shape[0] == 2
    A0, _ = WS.decode_positions(torch.from_numpy(nw), _mds(md), 512)
    A0 = A0.numpy()
    pos = 0
    for _ in range(300):
        pos += int(A0[0, pos % 64, pos // 64]) & 63      # advance bits
    return nw, hs, sizes, md, np.array([pos, -1], np.int32)


@pytest.mark.parametrize("stop", [False, True], ids=["eob", "stop_bit"])
def test_split_wave_decode_matches_reference(split_bucket, stop,
                                             monkeypatch):
    nw, hs, sizes, md, stop_bits = split_bucket
    sb = stop_bits if stop else None
    monkeypatch.delenv("DT_STAGEAB_PALLAS", raising=False)
    want = JW.wave_decode(jnp.asarray(nw), jnp.asarray(hs),
                          jnp.asarray(sizes),
                          {k: jnp.asarray(v) for k, v in md.items()}, 512,
                          interpret=True,
                          stop_bit=None if sb is None else jnp.asarray(sb))
    args = (torch.from_numpy(nw), torch.from_numpy(hs),
            torch.from_numpy(sizes), {k: torch.from_numpy(v)
                                      for k, v in md.items()}, 512,
            None if sb is None else torch.from_numpy(sb))
    monkeypatch.setenv("DT_STAGEAB_PALLAS", "0")
    calls = []
    monkeypatch.setattr(WS, "decode_mark",
                        lambda *a: calls.append("fused"))
    got = W.wave_decode(*args)
    assert calls == []                      # K2's route was not taken
    for g, w, name in zip(got, want, OUTS):
        assert_same(g, w, name)
    if stop:
        assert int(got[4][0]) < int(sizes[0])
        assert int(got[4][1]) == int(sizes[1])
    else:
        assert (got[4].numpy() == sizes).all() and not got[5].any()
