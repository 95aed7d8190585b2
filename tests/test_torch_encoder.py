"""Port vs reference, whole encode: stream, block offsets and bits, decode
hints and the binary manifest are identical to deflate_tpu's
compress_with_manifest at levels 0-3, and every stream round-trips
through zlib.  Level 3 covers text with long repeats, a bitmap-like
block (low byte entropy: the 4096-byte far-match cut), random bytes
(stored) and a two-block input."""
import zlib

import numpy as np
import pytest
import torch

from deflate_tpu.runtime import manifest as JM
from deflate_tpu_torch.models import encoder as E
from deflate_tpu_torch.runtime import manifest as M
from torch_helpers import corpus


def _bitmap(rows: int = 90, width: int = 320) -> bytes:
    """A 4-colour bitmap: each row the previous one with a few pixels
    changed, so matches sit a row stride (320 bytes) back."""
    rng = np.random.default_rng(14)
    row = rng.choice(np.array([0, 0x40, 0x80, 0xFF], np.uint8), width,
                     p=[0.6, 0.2, 0.15, 0.05])
    out = []
    for _ in range(rows):
        row = row.copy()
        hit = rng.random(width) < 0.04
        row[hit] = rng.choice(np.array([0, 0x40, 0x80], np.uint8),
                              int(hit.sum()))
        out.append(row)
    return np.concatenate(out).tobytes()


CASES = {
    "empty": (b"", 2),
    "one_byte": (b"x", 2),
    "random": (np.random.default_rng(9).integers(
        0, 256, 5000, dtype=np.uint8).tobytes(), 2),
    "text": (corpus(1, seed=3)[:20000], 2),
    "level0": (corpus(1, seed=4)[:6000], 0),
    "level1": (corpus(1, seed=5)[:6000], 1),
    "l3_text": ((corpus(1, seed=6)[:9000] * 3)[:26000], 3),
    "l3_bitmap": (_bitmap(), 3),
    "l3_random": (np.random.default_rng(10).integers(
        0, 256, 6000, dtype=np.uint8).tobytes(), 3),
    "l3_two_blocks": (corpus(2, seed=8)[:45000], 3),
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


def test_level3_far_match_cut_by_entropy():
    """The bitmap-like block takes the 4096-byte cut, text and random
    bytes the 256-byte one."""
    names = ("l3_text", "l3_bitmap", "l3_random")
    blocks = np.zeros((3, 32768), np.uint8)
    for i, k in enumerate(names):
        d = CASES[k][0]
        blocks[i, :len(d)] = np.frombuffer(d, np.uint8)
    blens = torch.tensor([len(CASES[k][0]) for k in names], dtype=torch.int32)
    cut = E._toofar3_by_entropy(torch.from_numpy(blocks), blens)
    assert cut.tolist() == [256, 4096, 256]
