"""Port vs reference, whole wavefront device decode: words, produced
counts and error flags of inflate_wave_device are identical to
deflate_tpu's (Pallas kernels in interpret mode) — including the flagged
CCAP-overflow block — and decode_all returns the original bytes."""
import zlib

import numpy as np
import pytest

from deflate_tpu.models import wave_decoder as JWD
from deflate_tpu_torch.models import wave_decoder as WD
from deflate_tpu_torch.ops import wave as W
from deflate_tpu_torch.runtime import manifest as M
from test_ccap_overflow import _craft_stream
from torch_helpers import corpus


def _encoded(data: bytes):
    stream, man = M.compress_with_manifest(data, level=2)
    return (stream, [b[0] for b in man.blocks], [b[2] for b in man.blocks],
            man.hint_array(), data)


def _ccap():
    stream, data = _craft_stream()
    return stream, [0], [len(data)], None, data


def _compare(stream, offs, sizes, hints):
    jw, jp, je = JWD.inflate_wave_device(stream, offs, sizes, hints,
                                         interpret=True)
    tw, tp, te = WD.inflate_wave_device(stream, offs, sizes, hints)
    assert (tw == np.asarray(jw)).all()
    assert (tp == np.asarray(jp)).all()
    assert (te == np.asarray(je)).all()
    return tw, tp, te


@pytest.mark.parametrize("make", [
    lambda: _encoded(b"a" * 100000),
    lambda: _encoded(corpus(1, seed=31)[:9000]),
    _ccap,
], ids=["run_of_a_4_blocks", "text", "ccap_overflow"])
def test_inflate_wave_device_identical(make):
    stream, offs, sizes, hints, data = make()
    words, produced, err = _compare(stream, offs, sizes, hints)
    w = words.view(np.uint8).reshape(len(offs), -1)
    out = b"".join(w[b, :produced[b]].tobytes() for b in range(len(offs)))
    if err.any():
        assert hints is None            # only the crafted CCAP stream
    else:
        assert out == data


@pytest.mark.parametrize("nblocks", [1, 3, 4])
def test_decode_all_roundtrip(nblocks):
    data = corpus(nblocks, seed=40 + nblocks)[:nblocks * 32768 - 1234]
    stream, man = M.compress_with_manifest(data, level=2)
    assert zlib.decompress(stream, -15) == data
    assert M.decode_all(stream, man, device="cpu") == data
    assert M.decode_all(stream, man) == data            # host path
    _, produced, err = WD.inflate_wave_device(
        stream, [b[0] for b in man.blocks], [b[2] for b in man.blocks],
        man.hint_array())
    assert not err.any()
    assert list(produced) == [b[2] for b in man.blocks]


def test_decode_all_falls_back_on_flagged_block():
    """The CCAP-overflow block is flagged by the wave path and decoded by
    the host fallback."""
    stream, data = _craft_stream()
    walk, span = W.hints_from_walk_host(stream, [0])
    hints = walk[0, :-(-int(span[0]) // 64)].tobytes()
    man = M.Manifest(32768, 8 * len(stream), [(0, 8 * len(stream),
                                                len(data))], [hints])
    _, _, err = WD.inflate_wave_device(stream, [0], [len(data)],
                                       man.hint_array())
    assert err.all()
    assert M.decode_all(stream, man, device="cpu") == data
