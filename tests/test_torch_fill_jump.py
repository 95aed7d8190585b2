"""Port vs reference, kernel K4's design: fill_matches_jump (the torch
form of csrc/wave_fill.cu's pointer jumping) equals the ordered copy
fill_matches_plain and deflate_tpu's fill_matches (Pallas interpret
mode), bit for bit — on every distance class, word phase and length
(fill_case), on the real records of level-2 and level-3 hinted decodes,
and on a row whose records reach byte 0 through the source clamp."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deflate_tpu.ops import wave_fill as JWF
from deflate_tpu_torch.models import wave_decoder as WD
from deflate_tpu_torch.ops import wave_fill as WF
from deflate_tpu_torch.runtime import manifest as M
from torch_helpers import NM, assert_same, corpus, fill_case


def check_all(lit, recs, nmatch):
    """Rows padded to the reference's multiple of JWF.K; the jump form
    against the plain version and the reference."""
    B = lit.shape[0]
    pad = -B % JWF.K
    lit = torch.cat([lit, torch.zeros((pad, lit.shape[1]), dtype=torch.int32)])
    recs = torch.cat([recs, torch.zeros((pad, recs.shape[1]),
                                        dtype=torch.int32)])
    nmatch = torch.cat([nmatch, torch.zeros(pad, dtype=torch.int32)])
    got = WF.fill_matches_jump(lit, recs, nmatch)
    assert_same(got, WF.fill_matches_plain(lit, recs, nmatch), "vs plain")
    want = JWF.fill_matches(jnp.asarray(lit.numpy()), jnp.asarray(recs.numpy()),
                            jnp.asarray(nmatch.numpy()), lit.shape[0],
                            interpret=True)
    assert_same(got, want, "vs fill_matches (interpret)")


def test_jump_on_fill_case():
    lit, rec0, rec1, nmatch = fill_case(8)
    check_all(torch.from_numpy(lit),
              WF.pack_fill_recs(torch.from_numpy(rec0),
                                torch.from_numpy(rec1)),
              torch.from_numpy(nmatch))


@pytest.mark.parametrize("level", [2, 3])
def test_jump_on_hinted_decode_records(level, monkeypatch):
    """The records wave_decode_filled hands the fill in a hinted decode
    of corpus(4): text, one merged run of 509-byte repeats, words."""
    data = corpus(4)
    stream, man = M.compress_with_manifest(data, level=level, device="cpu")
    calls = []
    fill = WF.fill_matches

    def capture(*args):
        calls.append(args)
        return fill(*args)

    monkeypatch.setattr(WF, "fill_matches", capture)
    _, _, err = WD.inflate_wave_device(
        stream, [b[0] for b in man.blocks], [b[2] for b in man.blocks],
        man.hint_array(), device="cpu")
    assert not err.any() and calls
    lit, recs, nmatch = (torch.cat([c[i] for c in calls]) for i in range(3))
    assert int(nmatch.sum()) > 1000
    check_all(lit, recs, nmatch)


def test_jump_with_sources_clamped_to_byte_0():
    """Records whose distance reaches before the row: pack_fill_recs
    clamps the source to byte 0, so they copy the row's start with
    period opos, long (periodic) and short."""
    rng = np.random.default_rng(3)
    lit = rng.integers(-2**31, 2**31, (1, 8192), dtype=np.int64)
    rec0 = np.zeros((1, NM), np.int32)
    rec1 = np.zeros((1, NM), np.int32)
    recs = [(5, 40, 7), (50, 3, 1000), (60, 258, 32768), (400, 4, 399),
            (500, 100, 50), (1000, 258, 2000)]      # (opos, len, dist)
    for m, (opos, ln, dist) in enumerate(recs):
        rec0[0, m] = opos | (ln - 3) << 16
        rec1[0, m] = dist
    packed = WF.pack_fill_recs(torch.from_numpy(rec0), torch.from_numpy(rec1))
    assert (packed[0, 1:2 * len(recs):2].numpy() == 0).sum() == 4
    check_all(torch.from_numpy(lit.astype(np.int32)), packed,
              torch.tensor([len(recs)], dtype=torch.int32))
