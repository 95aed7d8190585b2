"""The reference decoder and the stream checks on streams written by
zlib, and on streams that break RFC 1951."""
import zlib

import numpy as np
import pytest

from codecbench import judge
from codecbench.data.mixed_corpus import make_corpus
from codecbench.reference.inflate import StreamError, inflate


def _raw(data, level, strategy=zlib.Z_DEFAULT_STRATEGY):
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
    return co.compress(data) + co.flush()


DATA = make_corpus(np.random.default_rng(11), 200_000)


@pytest.mark.parametrize("level,strategy", [
    (0, zlib.Z_DEFAULT_STRATEGY), (1, zlib.Z_DEFAULT_STRATEGY),
    (6, zlib.Z_DEFAULT_STRATEGY), (9, zlib.Z_FILTERED),
    (6, zlib.Z_FIXED), (6, zlib.Z_HUFFMAN_ONLY), (6, zlib.Z_RLE)])
def test_inflate_matches_zlib(level, strategy):
    raw = _raw(DATA, level, strategy)
    out, blocks = inflate(raw, want_phases=True)
    assert out == DATA
    assert sum(b.out_len for b in blocks) == len(DATA)
    end = blocks[-1].bit_offset + blocks[-1].bit_len
    assert -(-end // 8) == len(raw)
    for a, b in zip(blocks, blocks[1:]):
        assert a.bit_offset + a.bit_len == b.bit_offset
    assert not judge.stream_faults(raw, DATA)["stream"]


def test_phases_point_at_symbol_starts():
    raw = _raw(DATA[:5000], 6)
    _, blocks = inflate(raw, want_phases=True)
    ph = blocks[0].phases
    assert ph[0] == 0 and all(p < 64 for p in ph)


@pytest.mark.parametrize("bad", [b"", b"\x07", b"\x01\x05\x00\x00\x00",
                                 b"\xff" * 64])
def test_broken_streams_raise(bad):
    with pytest.raises(StreamError):
        inflate(bad)


def test_truncated_and_trailing_streams_are_wrong():
    raw = _raw(DATA, 6)
    assert judge.stream_faults(raw[:-100], DATA)["stream"]
    assert judge.stream_faults(raw + b"\0", DATA)["stream"]
    assert judge.stream_faults(raw + b"\0", DATA)["zlib"]
