"""Port vs reference, the native skeleton walk: the port's own build of
native/inflate.cpp plans every stream exactly as deflate_tpu's native
library does (virtual-block index, flags, spans and hints), and rejects
the same malformed buffers with the same error.  The walk in pieces on
threads (dt_skeleton_par) gives the sequential walk's plan byte for byte
and its outcome on every malformed buffer."""
import functools
import gzip
import os
import zlib

import numpy as np
import pytest

from deflate_tpu import native as JN
from deflate_tpu.models import host_inflate as JHI
from deflate_tpu_torch import native as N
from deflate_tpu_torch.models import host_inflate as HI
from deflate_tpu_torch.runtime import manifest as M
from deflate_tpu_torch.utils import metrics
from torch_helpers import corpus, jax_native_lib


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    """The JAX package's native library, loaded before any test here
    compares against it."""
    jax_native_lib()


KEYS = ("parent_bit", "start_bit", "out_len", "flags", "span_bits",
        "out_start", "btype", "hints")


def _same_plan(stream: bytes):
    got, want = N.skeleton(stream), JN.skeleton(stream)
    for k in KEYS:
        assert (np.asarray(got[k]) == np.asarray(want[k])).all(), k
    assert got["total_out"] == want["total_out"]
    return got


def test_own_level2_stream():
    data = corpus(3, seed=81)
    stream, _ = M.compress_with_manifest(data, level=2, device="cpu")
    plan = _same_plan(stream)
    assert plan["total_out"] == len(data)
    assert ((plan["flags"] & 2) > 0).all() and not (plan["flags"] & 4).any()


def test_foreign_zlib9_text():
    big = b"The quick brown fox jumps over the lazy dog. " * 20000
    plan = _same_plan(zlib.compress(big, 9)[2:-4])
    assert plan["total_out"] == len(big)
    assert (plan["out_len"] <= 32768).all()
    assert ((plan["flags"] & 4) > 0).any()


def _outcome(fn, buf):
    try:
        plan = fn(buf)
    except ValueError as e:
        return "raise", str(e)
    return "plan", tuple(np.asarray(plan[k]).tobytes() for k in KEYS)


def test_garbage_fails_the_same_way():
    rng = np.random.default_rng(99)
    raised = 0
    for _ in range(300):
        n = int(rng.integers(1, 700))
        buf = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        got = _outcome(N.skeleton, buf)
        assert got == _outcome(JN.skeleton, buf)
        raised += got[0] == "raise"
    assert raised > 200


def test_native_inflate_matches_zlib():
    data = corpus(2, seed=82)
    raw = zlib.compress(data, 6)[2:-4]
    assert N.inflate(raw, 1024) == data
    small = zlib.compress(data[:2000], 6)             # the Python decoder
    assert HI.inflate_zlib(small) == JHI.inflate_zlib(small) == data[:2000]
    with pytest.raises(ValueError, match="capacity"):
        N.inflate(raw, len(data) - 1, exact=True)


def _zlib_raw(data: bytes, level: int, strategy=zlib.Z_DEFAULT_STRATEGY):
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
    return c.compress(data) + c.flush()


def _stored_wrapped(small: bool) -> bytes:
    """A zlib-6 stream as the payload of stored blocks: true dynamic
    headers inside stored payloads, which no piece may be taken from.
    zlib's level 0 writes blocks of up to 64 KiB; small: blocks of
    500-6,000 bytes, so that most pieces of 1 KiB hold headers of both."""
    inner = _zlib_raw(corpus(12, seed=85), 6)
    if not small:
        return _zlib_raw(inner, 0)
    rng = np.random.default_rng(85)
    out, i = bytearray(), 0
    while i < len(inner):
        n = min(int(rng.integers(500, 6001)), len(inner) - i)
        out += bytes([i + n == len(inner)])           # BFINAL, BTYPE 0
        out += n.to_bytes(2, "little") + (n ^ 0xFFFF).to_bytes(2, "little")
        out += inner[i:i + n]
        i += n
    return bytes(out)


MIXED = functools.partial(corpus, 12, 83)
STREAMS = {
    "zlib1": lambda: _zlib_raw(MIXED(), 1),
    "zlib6": lambda: _zlib_raw(MIXED(), 6),
    "zlib9": lambda: _zlib_raw(MIXED(), 9),
    "fixed": lambda: _zlib_raw(MIXED(), 6, zlib.Z_FIXED),
    "huffman_only": lambda: _zlib_raw(MIXED(), 6, zlib.Z_HUFFMAN_ONLY),
    "rle": lambda: _zlib_raw(MIXED(), 6, zlib.Z_RLE),
    "level0": lambda: _zlib_raw(MIXED(), 0),
    "own_level2": lambda: M.compress_with_manifest(
        corpus(3, seed=86), level=2, device="cpu")[0],
    "own_level3": lambda: M.compress_with_manifest(
        corpus(3, seed=87), level=3, device="cpu")[0],
    "gzip": lambda: gzip.compress(corpus(6, seed=88), 5, mtime=0)[10:-8],
    "one_byte": lambda: _zlib_raw(b"x", 6),
    "stored_wrapped": lambda: _stored_wrapped(False),
    "stored_wrapped_small": lambda: _stored_wrapped(True),
}


@functools.lru_cache(maxsize=None)
def _stream(name: str) -> bytes:
    return STREAMS[name]()


@functools.lru_cache(maxsize=None)
def _sequential(name: str):
    """dt_skeleton's plan of the stream, held against the JAX package's."""
    stream = _stream(name)
    plan, stats = N._skeleton(stream, 1, 0)
    assert stats == (0, 0, 0)
    want = JN.skeleton(stream)
    for k in KEYS:
        assert np.array_equal(plan[k], np.asarray(want[k])), k
    assert plan["total_out"] == want["total_out"]
    return plan


@pytest.mark.parametrize("piece", ["1k", "sixth"])
@pytest.mark.parametrize("threads", [1, 2, 3, 8])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_walk_in_pieces_equals_sequential_walk(name, threads, piece):
    stream = _stream(name)
    want = _sequential(name)
    pb = 1024 if piece == "1k" else len(stream) // 6 + 1
    got, (pieces, taken, rewalked) = N._skeleton(stream, threads, pb)
    for k in KEYS:
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k
    assert got["total_out"] == want["total_out"]
    n = -(-len(stream) // pb)
    assert pieces == (n - 1 if n > 1 else 0)
    assert 0 <= taken <= pieces and rewalked >= 0


def _seq_outcome(buf):
    return _outcome(lambda b: N._skeleton(b, 1, 0)[0], buf)


@pytest.mark.parametrize("threads", [2, 3])
def test_malformed_buffers_fail_as_the_sequential_walk(threads):
    """Garbage, streams cut at every piece offset (and a byte either
    side) and one-byte flips: the walk in pieces gives the sequential
    walk's plan or its error."""
    rng = np.random.default_rng(90 + threads)
    cases = []                                  # (buffer, piece bytes)
    for _ in range(60):
        n = int(rng.integers(1, 9000))
        cases.append((rng.integers(0, 256, n, np.uint8).tobytes(),
                      int(rng.choice([64, 1024]))))
    for name in ("zlib6", "fixed", "level0", "stored_wrapped_small"):
        s = _stream(name)[:60000]
        for cut in range(1024, len(s), 1024):
            cases += [(s[:cut + d], 1024) for d in (-1, 0, 1)]
        for _ in range(12):
            bad = bytearray(s)
            bad[int(rng.integers(0, len(s)))] ^= int(rng.integers(1, 256))
            cases.append((bytes(bad), 1024))
    raised = 0
    for buf, pb in cases:
        got = _outcome(lambda b: N._skeleton(b, threads, pb)[0], buf)
        assert got == _seq_outcome(buf)
        raised += got[0] == "raise"
    assert raised > len(cases) // 2


def test_counters_of_a_stream_walked_in_pieces(monkeypatch):
    """skeleton() on four cores: a 256 KB zlib-6 stream is cut into four
    pieces of 64 KiB; in the stored-wrapped stream the stitch walks the
    stored blocks again."""
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(4)))
    counts = {}
    for name in ("zlib6", "stored_wrapped"):
        stream = _stream(name)
        assert len(stream) > 2 * N.MIN_PIECE
        metrics.reset()
        plan = N.skeleton(stream)
        assert np.array_equal(plan["hints"], _sequential(name)["hints"])
        counts[name] = metrics.snapshot()["counts"]
    z = counts["zlib6"]
    assert z["skeleton.pieces"] == -(-len(_stream("zlib6")) // N.MIN_PIECE) - 1
    assert z["skeleton.pieces"] >= 2
    assert z["skeleton.pieces_taken"] >= 1
    assert counts["stored_wrapped"]["skeleton.blocks_rewalked"] > 0
