"""Port vs reference, the single-transfer bucketed decode
(deflate_tpu_torch/models/wave_decoder.py against deflate_tpu's): every
bucket's operands packed into one int32 buffer (_pack_bucket), copied to
the device once for all buckets (prepare_bucketed), sliced back apart
and decoded into one [n, OW+2] result a bucket (wave_decode_packed), the
results pulled back in one copy (inflate_wave_device)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deflate_tpu.models import wave_decoder as JWD
from deflate_tpu.ops import wave_fill as JWF
from deflate_tpu_torch.models import wave_decoder as WD
from deflate_tpu_torch.runtime import manifest as M
from torch_helpers import corpus


def _prep(data: bytes):
    stream, man = M.compress_with_manifest(data, level=2, device="cpu")
    offs = [b[0] for b in man.blocks]
    sizes = [b[2] for b in man.blocks]
    return stream, offs, sizes, man.hint_array()


@pytest.fixture(scope="module")
def quarters():
    """8 blocks of the bench corpus (text, repeats, words, random
    quarters): Huffman blocks in three buckets, stored blocks."""
    return _prep(corpus(8, seed=44))


@pytest.mark.parametrize("W64,n", [(512, 1), (2560, 7), (4224, 64)])
def test_bucket_words_match_reference(W64, n):
    assert WD._bucket_words(W64, n) == JWD._bucket_words(W64, n)


def test_pack_bucket_matches_reference(quarters):
    prep = WD._common_prep(*quarters)
    buckets = list(WD._iter_buckets(prep))
    assert len(buckets) >= 2
    jprep = JWD._common_prep(*quarters)
    jb = list(JWD._iter_buckets(jprep))
    assert [b[2] for b in buckets] == [b[2] for b in jb]
    for (sel, packed, W64, n, mm), (jsel, jpacked, jW64, jn, jnpad, jmm) \
            in zip(buckets, jb):
        assert np.array_equal(sel, jsel) and (W64, n, mm) == (jW64, jn, jmm)
        assert packed.dtype == jpacked.dtype == np.int32
        assert np.array_equal(packed, jpacked)
        assert packed.size == WD._bucket_words(W64, n)


def test_unpack_bucket_gives_the_operands_back(quarters):
    """Hints come back from their little-endian words; every operand is
    a contiguous tensor (the kernels take raw pointers)."""
    from deflate_tpu_torch.ops import wave as W

    prep = WD._common_prep(*quarters)
    sel, packed, W64, n, _ = next(iter(WD._iter_buckets(prep)))
    nw, hints, sizes, md = WD._unpack_bucket(torch.from_numpy(packed), W64,
                                             n)
    hsel = np.full((n, W64), W.HINT_NONE, np.uint8)
    hav = min(W64, prep["hints"].shape[1])
    hsel[:, :hav] = prep["hints"][sel][:, :hav]
    assert np.array_equal(hints.numpy(), hsel)
    assert np.array_equal(sizes.numpy(), prep["out_sizes"][sel])
    assert np.array_equal(nw.numpy(), W.prepare_windows(
        prep["stream"], prep["md"]["data_start"][sel], W64))
    for k, v in md.items():
        assert np.array_equal(v.numpy(), prep["md"][k][sel]), k
    for t in (nw, hints, sizes, *md.values()):
        assert t.is_contiguous()


def test_wave_decode_packed_matches_reference():
    """One bucket (W64 512) at a nonzero offset in a shared buffer: the
    [n, OW+2] result equals the reference's (Pallas in interpret mode)."""
    args = _prep(corpus(1, seed=31)[:9000] * 2)
    prep = WD._common_prep(*args)
    (sel, packed, W64, n, (ml, mdx)), = WD._iter_buckets(prep)
    junk = np.arange(37, dtype=np.int32)
    shared = np.concatenate([junk, packed])
    got = WD.wave_decode_packed(torch.from_numpy(shared), W64, n, off=37,
                                maxl=ml, maxd=mdx)
    npad = -(-n // JWF.K) * JWF.K
    want = JWD.wave_decode_packed(jnp.asarray(shared), W64, n, npad, True,
                                  off=37, maxl=ml, maxd=mdx)
    assert got.shape == (n, JWF.OW + 2)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert not got[:, -1].any()


def test_prepare_bucketed_shares_one_buffer(quarters):
    prep, calls = WD.prepare_bucketed(*quarters, device="cpu")
    bufs = {id(c[1][0]) for c in calls}
    assert len(calls) >= 2 and len(bufs) == 1
    offs = [c[1][1] for c in calls]
    sizes = [WD._bucket_words(c[2], c[3]) for c in calls]
    assert offs == list(np.cumsum([0] + sizes[:-1]))
    assert calls[0][1][0].numel() == sum(sizes)
    assert prep["stored_words"] is not None


def test_inflate_wave_device_copies_once_each_way(quarters, monkeypatch):
    """One host-to-device copy (Tensor.to a device) and one device-to-host
    copy (Tensor.cpu) for all buckets; the bytes still decode."""
    counts = {"to": 0, "cpu": 0}
    real_to, real_cpu = torch.Tensor.to, torch.Tensor.cpu

    def to(self, *a, **k):
        if any(isinstance(x, (torch.device, str)) for x in a) \
                or "device" in k:
            counts["to"] += 1
        return real_to(self, *a, **k)

    def cpu(self, *a, **k):
        counts["cpu"] += 1
        return real_cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "to", to)
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    words, produced, err = WD.inflate_wave_device(*quarters, device="cpu")
    monkeypatch.undo()
    assert counts == {"to": 1, "cpu": 1}
    assert not err.any()
    assert np.array_equal(produced, quarters[2])
