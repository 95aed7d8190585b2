"""Port vs reference, the wavefront decoder's host header parse: the
port's parse_headers_host (native dt_parse_headers walk plus the
vectorised _canon_meta_batch) against the reference's parse_headers_host
and its pure-Python walk _parse_headers_host_py, on every key, exactly:
manifest streams at levels 0-3, the skeleton plan's offsets of foreign
streams, and blocks with errors."""
import zlib

import numpy as np
import pytest

from chip_smoke import deflate_raw
from deflate_tpu.ops import wave as JW
from deflate_tpu_torch.models import wave_decoder as WD
from deflate_tpu_torch.ops import wave as W
from deflate_tpu_torch.runtime import manifest as M
from torch_helpers import corpus, dynamic_header, jax_native_lib, pack_fields


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    """The reference's parse_headers_host takes its native walk only
    when the JAX package's library loads."""
    jax_native_lib()


def _manifest(level: int):
    data = corpus(2, seed=41 + level)[:40000]
    stream, man = M.compress_with_manifest(data, level=level, device="cpu")
    return stream, [b[0] for b in man.blocks]


def _foreign(kind: str):
    rng = np.random.default_rng(43)
    text = bytes(rng.integers(97, 107, 120000, dtype=np.uint8))
    raw = {"zlib1": lambda: deflate_raw(text, 1),
           "zlib6": lambda: deflate_raw(text, 6),
           "zlib9": lambda: deflate_raw(text, 9),
           "fixed": lambda: deflate_raw(text[:50000], 6, zlib.Z_FIXED),
           "stored": lambda: deflate_raw(bytes(rng.integers(
               0, 256, 90000, dtype=np.uint8)), 0)}[kind]()
    return raw, WD.skeleton_plan(raw)["parent_bit"]


def _stored(length: int, nlen: int, payload: int) -> bytes:
    return pack_fields([(1, 1), (0, 2), (0, 5), (length, 16), (nlen, 16)]) \
        + b"x" * payload


ERRORS = {
    "btype3": lambda: pack_fields([(1, 1), (3, 2)]) + b"\0" * 8,
    "len_nlen_mismatch": lambda: _stored(5, 0x1234, 5),
    "stored_past_end": lambda: _stored(1000, 1000 ^ 0xFFFF, 10),
    # literals 0-6 and end-of-block all of length 1
    "oversubscribed_litlen": lambda: dynamic_header(
        257, 1, {0: 2, 1: 2, 16: 2, 18: 2},
        [(1, 0), (16, 3), (18, 127), (18, 100), (1, 0), (1, 0)])
        + b"\0" * 8,
}

CASES = ([f"level{k}" for k in range(4)]
         + ["zlib1", "zlib6", "zlib9", "fixed", "stored"] + list(ERRORS))


def _case(name: str):
    if name.startswith("level"):
        return _manifest(int(name[5:]))
    if name in ERRORS:
        return ERRORS[name](), [0]
    return _foreign(name)


@pytest.mark.parametrize("name", CASES)
def test_native_header_parse_matches_both_reference_parses(name,
                                                           monkeypatch):
    stream, offs = _case(name)
    offs = np.asarray(offs, np.int64)

    def no_python_walk(*a, **kw):
        raise AssertionError("parse_headers_host took the Python walk")

    monkeypatch.setattr(W, "_parse_headers_host_py", no_python_walk)
    got = W.parse_headers_host(stream, offs)
    monkeypatch.undo()
    for want in (JW.parse_headers_host(stream, offs),
                 JW._parse_headers_host_py(stream, offs),
                 W._parse_headers_host_py(stream, offs)):
        assert sorted(got) == sorted(want)
        for k in want:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert (g == w).all(), (name, k)
    assert got["hdr_err"].any() == (name in ERRORS)
