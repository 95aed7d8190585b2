"""Port vs reference, kernel K5 and the skeleton-planned decode:
fill_matches_hist's plain version equals deflate_tpu's fill_matches_hist
(Pallas interpret mode) on hand-built rows — every distance class, a
match reaching back across four earlier short rows, the 32 KiB maximum
distance, a zero-size row and odd sizes — and inflate_wave_planned
returns the same bytes and error flags as the reference on foreign zlib
streams (history, overlap, stored blocks, matches into stored bytes).
fill_matches_hist_jump, the torch form of the CUDA kernel's pointer
jumping, equals the plain version on full rows, tails included."""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deflate_tpu.models import wave_decoder as JWD
from deflate_tpu.ops import wave_fill as JWF
from deflate_tpu_torch.models import wave_decoder as WD
from deflate_tpu_torch.ops import wave_fill as WF
from torch_helpers import NM, fill_case, hist_case, jax_native_lib


def test_hist_case_shape():
    """The hand-built plan covers what the kernel must get right."""
    lit, rec0, rec1, nmatch, sizes = hist_case()
    assert 0 in sizes and any(s % 2 for s in sizes)
    starts = np.cumsum(sizes) - sizes
    # row 6's first record reaches across rows 5, 4, 3 and 2 into row 1
    assert (rec0[6, 0] & 0xFFFF) == 0 and rec1[6, 0] > starts[6] - starts[2]
    assert rec1.max() == 32768
    assert (nmatch <= NM).all()


def test_k5_plain_matches_fill_matches_hist_interpret():
    lit, rec0, rec1, nmatch, sizes = hist_case()
    B = len(sizes)
    recs = np.stack([rec0, rec1], 2).reshape(B, 2 * NM)
    want = JWF.fill_matches_hist(jnp.asarray(lit), jnp.asarray(recs),
                                 jnp.asarray(nmatch), jnp.asarray(sizes), B,
                                 interpret=True)
    got = WF.fill_matches_hist(torch.from_numpy(lit), torch.from_numpy(recs),
                               torch.from_numpy(nmatch),
                               torch.from_numpy(sizes))
    g = got.numpy().view(np.uint8).reshape(B, -1)
    w = np.asarray(want).view(np.uint8).reshape(B, -1)
    for b in range(B):
        assert (g[b, :sizes[b]] == w[b, :sizes[b]]).all(), b


def test_k5_plain_on_a_single_row_equals_k4_plain():
    """With no history, one row's hist fill is the per-block fill."""
    lit, rec0, rec1, nmatch = fill_case(1)
    # fill_case's first records reach before byte 0: start later
    rec0 = rec0.copy()
    rec0[0, :nmatch[0]] += 600
    recs = np.stack([rec0, rec1], 2).reshape(1, 2 * NM)
    got = WF.fill_matches_hist_plain(
        torch.from_numpy(lit), torch.from_numpy(recs),
        torch.from_numpy(nmatch), torch.tensor([32768], dtype=torch.int32))
    want = WF.fill_matches_plain(
        torch.from_numpy(lit),
        WF.pack_fill_recs(torch.from_numpy(rec0), torch.from_numpy(rec1)),
        torch.from_numpy(nmatch))
    assert (got.numpy() == want.numpy()).all()


def _foreign(name):
    rng = np.random.default_rng({"history": 0, "overlap": 5, "stored": 6,
                                 "into_stored": 7}[name])
    if name == "history":
        data = b"The quick brown fox jumps over the lazy dog. " * 4000
        return data, zlib.compress(data, 9)[2:-4]
    if name == "overlap":
        data = (b"a" * 100000 + b"ab" * 30000 + b"abc" * 20000
                + bytes(rng.integers(97, 100, 50000, dtype=np.uint8)))
        return data, zlib.compress(data, 9)[2:-4]
    if name == "stored":
        data = rng.integers(0, 256, 150000, dtype=np.uint8).tobytes()
        return data, zlib.compress(data, 1)[2:-4]
    rnd = rng.integers(0, 256, 40000, dtype=np.uint8).tobytes()
    data = rnd + rnd[:20000] + b"x" * 5000
    return data, zlib.compress(data, 6)[2:-4]


@pytest.mark.parametrize("name", ["history", "overlap", "stored",
                                  "into_stored"])
def test_inflate_wave_planned_matches_reference(name):
    jax_native_lib()
    data, enc = _foreign(name)
    plan = WD.skeleton_plan(enc)
    flags = np.asarray(plan["flags"])
    assert ((flags & 2) == 0).any() or ((flags & 4) > 0).any() \
        or ((flags & 1) > 0).any()
    got, gerr = WD.inflate_wave_planned(enc, plan, device="cpu")
    want, werr = JWD.inflate_wave_planned(enc, JWD.skeleton_plan(enc),
                                          interpret=True)
    assert (gerr == np.asarray(werr)).all()
    assert got == want == data
    if name == "history":
        assert ((flags & 4) > 0).any()
    if name == "stored":
        assert ((flags & 1) > 0).any()


def _hist_args():
    lit, rec0, rec1, nmatch, sizes = hist_case()
    recs = np.stack([rec0, rec1], 2).reshape(len(sizes), 2 * NM)
    return lit, recs, nmatch, sizes


def test_k5_jump_equals_plain_on_full_rows():
    args = [torch.from_numpy(x) for x in _hist_args()]
    got = WF.fill_matches_hist_jump(*args)
    want = WF.fill_matches_hist_plain(*args)
    assert (got.numpy() == want.numpy()).all()


def test_k5_jump_matches_fill_matches_hist_interpret():
    lit, recs, nmatch, sizes = _hist_args()
    B = len(sizes)
    want = JWF.fill_matches_hist(jnp.asarray(lit), jnp.asarray(recs),
                                 jnp.asarray(nmatch), jnp.asarray(sizes), B,
                                 interpret=True)
    got = WF.fill_matches_hist_jump(
        *[torch.from_numpy(x) for x in (lit, recs, nmatch, sizes)])
    g = got.numpy().view(np.uint8).reshape(B, -1)
    w = np.asarray(want).view(np.uint8).reshape(B, -1)
    for b in range(B):
        assert (g[b, :sizes[b]] == w[b, :sizes[b]]).all(), b


@pytest.mark.parametrize("name", ["history", "overlap", "stored",
                                  "into_stored"])
def test_k5_jump_decodes_foreign_streams(name, monkeypatch):
    """The planned decode with the jump form in place of the ordered fill
    gives the stream's bytes, and the jump form equals the plain version
    on every row of the plan's fill."""
    data, enc = _foreign(name)
    calls = []

    def jump(*args):
        calls.append(args)
        return WF.fill_matches_hist_jump(*args)

    monkeypatch.setattr(WF, "fill_matches_hist", jump)
    got, err = WD.inflate_wave_planned(enc, WD.skeleton_plan(enc),
                                       device="cpu")
    assert got == data and not err.any()
    assert len(calls) <= 1
    for args in calls:
        want = WF.fill_matches_hist_plain(*args)
        assert (WF.fill_matches_hist_jump(*args).numpy()
                == want.numpy()).all()
