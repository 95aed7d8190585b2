"""Port vs reference, whole encode of one-block inputs: stream, block
offsets and bits, decode hints and the binary manifest are identical to
deflate_tpu's compress_with_manifest at levels 0, 1 and 2, and every
stream round-trips through zlib."""
import zlib

import numpy as np
import pytest

from deflate_tpu.runtime import manifest as JM
from deflate_tpu_torch.runtime import manifest as M
from torch_helpers import corpus

CASES = {
    "empty": (b"", 2),
    "one_byte": (b"x", 2),
    "random": (np.random.default_rng(9).integers(
        0, 256, 5000, dtype=np.uint8).tobytes(), 2),
    "text": (corpus(1, seed=3)[:20000], 2),
    "level0": (corpus(1, seed=4)[:6000], 0),
    "level1": (corpus(1, seed=5)[:6000], 1),
}


@pytest.fixture(scope="module")
def reference():
    """The JAX encoder's (stream, manifest) for every case, computed once
    per worker (one compile per level)."""
    return {k: JM.compress_with_manifest(d, level=lv)
            for k, (d, lv) in CASES.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_and_manifest_identical(reference, case):
    data, level = CASES[case]
    want_s, want_m = reference[case]
    got_s, got_m = M.compress_with_manifest(data, level=level, device="cpu")
    assert got_s == want_s
    assert got_m.blocks == want_m.blocks
    assert got_m.hints == want_m.hints
    assert got_m.total_bits == want_m.total_bits
    assert got_m.to_bytes() == want_m.to_bytes()
    assert zlib.decompress(got_s, -15) == data


def test_manifests_read_across_packages(reference):
    _, jm = reference["text"]
    tm = M.Manifest.from_bytes(jm.to_bytes())
    assert (tm.blocks, tm.hints, tm.total_bits) == \
        (jm.blocks, jm.hints, jm.total_bits)
    back = JM.Manifest.from_bytes(tm.to_bytes())
    assert (back.blocks, back.hints) == (jm.blocks, jm.hints)
    assert (tm.hint_array() == jm.hint_array()).all()


def test_level3_not_ported():
    with pytest.raises(NotImplementedError):
        M.compress_with_manifest(b"abc" * 100, level=3, device="cpu")
