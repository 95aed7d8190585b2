"""Port vs reference, the native skeleton walk: the port's own build of
native/inflate.cpp plans every stream exactly as deflate_tpu's native
library does (virtual-block index, flags, spans and hints), and rejects
the same malformed buffers with the same error."""
import zlib

import numpy as np
import pytest

from deflate_tpu import native as JN
from deflate_tpu.models import host_inflate as JHI
from deflate_tpu_torch import native as N
from deflate_tpu_torch.models import host_inflate as HI
from deflate_tpu_torch.runtime import manifest as M
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
