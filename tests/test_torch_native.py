"""Port vs reference, the native host library and the host helpers of
the public API: ``native.deflate`` at levels 0-3, ``stitch`` against the
numpy loop ``stitch_segments_plain`` and the reference's
``stitch_segments``, ``inflate_consumed`` and
``host_inflate.inflate_raw_consumed``, ``inflate_block_streaming``,
``adler32`` and ``rfc_tables`` against utils/tables.py.  All host code:
the same bytes in, the same bytes (or the same exception type) out."""
import zlib

import numpy as np
import pytest

from chip_smoke import word_text
from deflate_tpu import native as JN
from deflate_tpu.models import host_inflate as JHI
from deflate_tpu.runtime import stitch as JS
from deflate_tpu_torch import native
from deflate_tpu_torch.models import host_inflate as HI
from deflate_tpu_torch.runtime import stitch as S
from deflate_tpu_torch.utils import tables as T
from torch_helpers import corpus, jax_native_lib


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    jax_native_lib()


def _inputs():
    rng = np.random.default_rng(5)
    return {
        "empty": b"",
        "one_byte": b"q",
        "corpus_2_5_blocks": corpus(3, seed=8)[:2 * 32768 + 16000],
        "random": bytes(rng.integers(0, 256, 40000, dtype=np.uint8)),
        "runs": b"a" * 70000 + b"b" * 5,
    }


@pytest.mark.parametrize("level", [0, 1, 2, 3])
@pytest.mark.parametrize("name", list(_inputs()))
def test_native_deflate_matches_reference(name, level):
    data = _inputs()[name]
    got = native.deflate(data, level)
    assert got == JN.deflate(data, level)
    assert zlib.decompress(got, -15) == data


def _segments(rng, nbits_list, dtype):
    """Segments of random words with every bit past nbits zero."""
    segs = []
    for nb in nbits_list:
        nw = (nb + 31) // 32 + int(rng.integers(0, 3))   # spare words
        w = rng.integers(0, 1 << 32, nw, dtype=np.uint64).astype(np.uint32)
        keep = np.zeros(nw * 32, bool)
        keep[:nb] = True
        mask = np.packbits(keep.reshape(-1, 8)[:, ::-1], axis=1) \
            .reshape(-1).view("<u4")
        segs.append(((w & mask).astype(np.uint32).view(dtype), nb))
    return segs


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
def test_stitch_matches_plain_and_reference(dtype):
    """Bit lengths of every phase, zero-length and whole-word segments;
    int32 words (the port's encoder's) go in as a uint32 view."""
    rng = np.random.default_rng(3)
    nbits = [0, 1, 31, 32, 33, 0, 64, 7, 1000, 95, 3, 32 * 40 + 17]
    nbits += [int(n) for n in rng.integers(0, 600, 30)]
    segs = _segments(rng, nbits, dtype)
    got = S.stitch_segments(segs)
    plain = S.stitch_segments_plain(segs)
    want = JS.stitch_segments([(w.view(np.uint32), nb) for w, nb in segs])
    assert got[1] == plain[1] == want[1] == sum(nbits)
    assert got[0].dtype == np.uint32
    np.testing.assert_array_equal(got[0], plain[0])
    np.testing.assert_array_equal(got[0], want[0])
    assert S.words_to_bytes(*got) == JS.words_to_bytes(*want)


def test_stitch_of_no_segments():
    got = S.stitch_segments([])
    assert got[1] == 0 and not got[0].any()
    np.testing.assert_array_equal(got[0], JS.stitch_segments([])[0])


def _consumed_cases():
    text = b"consumed bytes and a trailer after them " * 500
    rng = np.random.default_rng(4)
    noise = bytes(rng.integers(0, 256, 3000, dtype=np.uint8))
    fixed = zlib.compressobj(6, zlib.DEFLATED, -15, 8, zlib.Z_FIXED)
    return {
        "zlib6_trailer": zlib.compress(text, 6)[2:-4] + b"TRAILER!",
        "stored_then_junk": zlib.compress(noise, 0)[2:-4] + noise[:100],
        "fixed": fixed.compress(text) + fixed.flush() + b"\x00" * 8,
        "empty_stream": b"\x03\x00" + b"xyz",
    }


@pytest.mark.parametrize("name", list(_consumed_cases()))
def test_inflate_consumed_matches_reference(name):
    data = _consumed_cases()[name]
    got = native.inflate_consumed(data, 1024)
    assert got == JN.inflate_consumed(data, 1024)
    assert HI.inflate_raw_consumed(data) == got
    assert JHI.inflate_raw_consumed(data) == got


@pytest.mark.parametrize("bad", [b"\x07\x00", b"\xff" * 16, b""])
def test_inflate_consumed_rejects_like_reference(bad):
    with pytest.raises(ValueError) as ours:
        native.inflate_consumed(bad, 1024)
    with pytest.raises(ValueError) as theirs:
        JN.inflate_consumed(bad, 1024)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(HI.InflateError):
        HI.inflate_raw_consumed(bad)
    with pytest.raises(JHI.InflateError):
        JHI.inflate_raw_consumed(bad)


def test_inflate_block_streaming_matches_reference():
    """Block by block through a zlib stream whose matches cross block
    boundaries, the history carried as decompress_file carries it."""
    data = word_text(np.random.default_rng(6), 150000)
    raw = zlib.compress(data, 9)[2:-4]
    pos, hist, out, blocks = 0, b"", b"", 0
    while True:
        got = HI.inflate_block_streaming(raw, pos, hist)
        assert got == JHI.inflate_block_streaming(raw, pos, hist)
        piece, pos, final = got
        out += piece
        hist = (hist + piece)[-32768:]
        blocks += 1
        if final:
            break
    assert out == data and blocks > 1


@pytest.mark.parametrize("name", ["empty", "one_byte", "random", "runs"])
def test_adler32_matches_zlib_and_reference(name):
    data = _inputs()[name]
    assert native.adler32(data) == zlib.adler32(data) == JHI.adler32(data) \
        == HI.adler32(data) == JN.adler32(data)


@pytest.mark.parametrize("which", ["inflate", "deflate"])
def test_rfc_tables_match_tables(which):
    got = native.rfc_tables(which)
    want = {"len_base": T.LENGTH_BASE, "len_extra": T.LENGTH_EXTRA,
            "dist_base": T.DIST_BASE, "dist_extra": T.DIST_EXTRA,
            "cl_order": T.CL_ORDER}
    ref = JN.rfc_tables(which)
    assert sorted(got) == sorted(want) == sorted(ref)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k], np.int32))
        np.testing.assert_array_equal(got[k], ref[k])
