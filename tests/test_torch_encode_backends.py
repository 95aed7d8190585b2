"""Port vs reference, encode_batch through each emission backend
("kernel": packet fusion, compaction on K3, placement on K7; "scatter";
"merge", the default) at levels 1-3: the stream words are identical to
the reference's, and offsets, bits and hints are the default backend's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deflate_tpu.models import encoder as JE
from deflate_tpu_torch.models import encoder as E
from torch_helpers import BLOCK, assert_same, corpus

LEVELS = (1, 2, 3)


@pytest.fixture(scope="module")
def two_blocks():
    """Two blocks (a full one of text and repeats, a partial one of words
    and random bytes) at stream phase 5; the reference's scatter-backend
    encode and the port's default-backend encode with hints at each
    level."""
    data = corpus(2, seed=12)
    data = data[16384:49152] + data[49152 + 8192:49152 + 8192 + 9000]
    buf = np.frombuffer(data, np.uint8)
    blocks = np.zeros((2, BLOCK), np.uint8)
    blocks[0] = buf[:BLOCK]
    blocks[1, :len(buf) - BLOCK] = buf[BLOCK:]
    blens = np.array([BLOCK, len(buf) - BLOCK], np.int32)
    live = np.ones(2, bool)
    args = (torch.from_numpy(blocks), torch.from_numpy(blens),
            torch.from_numpy(live), 1)
    want = {lv: JE.encode_batch(jnp.asarray(blocks), jnp.asarray(blens),
                                jnp.asarray(live), np.int32(1), lv, 5,
                                pack="scatter") for lv in LEVELS}
    base = {lv: E.encode_batch_with_hints(*args, lv, 5) for lv in LEVELS}
    return args, want, base


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("pack", ["kernel", "scatter", "merge"])
def test_encode_batch_backends_match_reference(two_blocks, pack, level):
    """The reference's kernel backend cannot run on the CPU; its backends
    are bit-identical, so its scatter one stands in.  The default
    backend's offsets, bits and hints are held against the reference in
    test_torch_encoder.py."""
    args, want, base = two_blocks
    got = E.encode_batch_with_hints(*args, level, 5, pack=pack)
    assert_same(got[0], want[level][0], f"L{level} {pack} words")
    assert int(got[1]) == int(want[level][1])
    for g, w, name in zip(got, base[level],
                          ("words", "total", "offset", "bits", "hints")):
        assert_same(g, w, f"L{level} {pack} {name}")


def test_encode_batch_is_the_head_of_with_hints(two_blocks):
    args, want, base = two_blocks
    words, total = E.encode_batch(*args, 2, 5, pack="kernel")
    assert_same(words, want[2][0], "words")
    assert int(total) == int(want[2][1])
    offset_bits = E.encode_batch_with_offsets(*args, 2, 5, pack="scatter")
    for g, w in zip(offset_bits, base[2]):
        assert_same(g, w)


def test_unknown_backend_raises(two_blocks):
    args, _, _ = two_blocks
    with pytest.raises(ValueError):
        E.encode_batch(*args, 1, 0, pack="tree")
