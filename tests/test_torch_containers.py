"""Port vs reference, the containers: ``compress_zlib`` and
``compress_gzip`` write the same bytes as deflate_tpu's, python's zlib
and gzip read them, and ``decompress_gzip`` decodes the cases of
tests/test_containers_batch.py (multi-member files, optional header
fields, FHCRC) to the same bytes, or raises InflateError where the
reference does (corrupt CRCs, malformed and truncated headers)."""
import gzip as _gzip
import zlib

import numpy as np
import pytest

import deflate_tpu
import deflate_tpu_torch as D
from torch_helpers import jax_native_lib

CASES = {
    "text": b"the gzip container test " * 400,
    "random": bytes(np.random.default_rng(0).integers(0, 256, 50000,
                                                      dtype=np.uint8)),
    "empty": b"",
}


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    jax_native_lib()


@pytest.mark.parametrize("name", CASES)
def test_gzip_matches_reference_and_stdlib(name):
    data = CASES[name]
    g = D.compress_gzip(data, 2, device="cpu")
    assert g == deflate_tpu.compress_gzip(data, 2)
    assert _gzip.decompress(g) == data
    theirs = _gzip.compress(data, 6)
    for blob in (g, theirs):
        assert D.decompress_gzip(blob) == deflate_tpu.decompress_gzip(blob) \
            == data


@pytest.mark.parametrize("name", CASES)
def test_zlib_matches_reference_and_stdlib(name):
    data = CASES[name]
    z = D.compress_zlib(data, 2, device="cpu")
    assert z == deflate_tpu.compress_zlib(data, 2)
    assert zlib.decompress(z) == data
    assert D.decompress_zlib(z, device=None) == data


def test_gzip_multi_member():
    a, b, c = b"first member " * 200, b"", b"third member! " * 150
    third = _gzip.compress(c, 6)
    cat = (D.compress_gzip(a, 2, device="cpu")
           + D.compress_gzip(b, 1, device="cpu") + third)
    assert cat == (deflate_tpu.compress_gzip(a, 2)
                   + deflate_tpu.compress_gzip(b, 1) + third)
    assert D.decompress_gzip(cat) == deflate_tpu.decompress_gzip(cat) \
        == _gzip.decompress(cat) == a + b + c


def _fancy_member(data: bytes, raw: bytes, flg: int = 0x1F) -> bytes:
    """A member with FTEXT|FHCRC|FEXTRA|FNAME|FCOMMENT (flg's bits)."""
    hdr = bytearray([0x1F, 0x8B, 8, flg, 0, 0, 0, 0, 0, 255])
    if flg & 0x04:
        hdr += (4).to_bytes(2, "little") + b"XTRA"
    if flg & 0x08:
        hdr += b"name.txt\x00"
    if flg & 0x10:
        hdr += b"a comment\x00"
    if flg & 0x02:
        hdr += (zlib.crc32(bytes(hdr)) & 0xFFFF).to_bytes(2, "little")
    return (bytes(hdr) + raw
            + (zlib.crc32(data) & 0xFFFFFFFF).to_bytes(4, "little")
            + (len(data) & 0xFFFFFFFF).to_bytes(4, "little"))


@pytest.mark.parametrize("flg", [0x1F, 0x02, 0x04, 0x08, 0x10, 0x1C])
def test_gzip_optional_header_fields(flg):
    data = b"payload with fancy header " * 64
    raw = D.compress(data, 2, device="cpu")
    assert raw == deflate_tpu.compress(data, 2)
    g = _fancy_member(data, raw, flg)
    assert _gzip.decompress(g) == data
    assert D.decompress_gzip(g) == deflate_tpu.decompress_gzip(g) == data


def _bad_gzips():
    data = b"hello world" * 100
    good = _gzip.compress(data, 6)
    raw = zlib.compress(data, 6)[2:-4]
    fancy = _fancy_member(data, raw)

    def flip(blob, i):
        b = bytearray(blob)
        b[i] ^= 0xFF
        return bytes(b)

    name_at = fancy.index(b"name.txt")
    return {
        "crc32": flip(good, len(good) - 6),
        "isize": flip(good, len(good) - 2),
        "header_crc16": flip(fancy, name_at + len(b"name.txt\x00a comment\x00")),
        "magic": flip(good, 1),
        "method": bytes(good[:2]) + b"\x07" + good[3:],
        "reserved_flags": bytes(good[:3]) + b"\xe0" + good[4:],
        "fname_without_nul": bytes([0x1F, 0x8B, 8, 0x08, 0, 0, 0, 0, 0, 255])
        + b"unterminated-name-no-nul" + raw,
        "fextra_truncated": bytes([0x1F, 0x8B, 8, 0x04, 0, 0, 0, 0, 0, 255])
        + (60000).to_bytes(2, "little") + b"x" * 20,
        "too_short": good[:17],
        "trailer_truncated": good[:-3],
        "corrupt_payload": flip(good, 12),
        "second_member_junk": good + b"\x1f\x8b\x08" + b"\x00" * 20,
        "member_truncated": good + good[:15],
    }


@pytest.mark.parametrize("name", list(_bad_gzips()))
def test_gzip_errors_match_reference(name):
    blob = _bad_gzips()[name]
    with pytest.raises(D.InflateError) as ours:
        D.decompress_gzip(blob)
    with pytest.raises(deflate_tpu.InflateError) as theirs:
        deflate_tpu.decompress_gzip(blob)
    assert str(ours.value) == str(theirs.value)
