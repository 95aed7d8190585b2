"""Port vs reference, stage C at levels 1-3: encode_batch's stream words
are the reference's; emit_block's per-block words (the stage C of
compress_many and compress_mesh), placed at their bit offsets, are
encode_batch's; and K7's route (emit_block_packed: packet fusion,
compaction on K3, placement on K7, their plain versions here) gives
emit_block's words."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deflate_tpu.models import encoder as JE
from deflate_tpu_torch.models import encoder as E
from deflate_tpu_torch.ops import bitmerge as BM
from torch_helpers import BLOCK, assert_same, corpus

LEVELS = (1, 2, 3)
PHASE0 = 5


@pytest.fixture(scope="module")
def two_blocks():
    """Two blocks (a full one of text and repeats, a partial one of words
    and random bytes) at stream phase 5; the reference's encode and the
    port's encode with hints at each level."""
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
                                jnp.asarray(live), np.int32(1), lv, PHASE0)
            for lv in LEVELS}
    base = {lv: E.encode_batch_with_hints(*args, lv, PHASE0)
            for lv in LEVELS}
    return args, want, base


def _stage_c_args(args, level):
    """emit_block's arguments for the two blocks at stream phase 5, and
    the blocks' bits."""
    blocks, blens, live, final_idx = args
    plans = E.batch_plan(blocks, blens, level)
    choice, pad, _, bits = E.choose_blocks(
        plans["fixed_bits"], plans["dyn_bits"], blens, live, level, PHASE0)
    bfinal = torch.arange(blocks.shape[0]) == final_idx
    return (blocks, blens, plans, choice, pad, bfinal), bits


@pytest.mark.parametrize("level", LEVELS)
def test_encode_batch_matches_reference(two_blocks, level):
    """Words and total bits; offsets, bits and hints are held against the
    reference in test_torch_encoder.py."""
    args, want, base = two_blocks
    words, total = base[level][:2]
    assert_same(words, want[level][0], f"L{level} words")
    assert int(total) == int(want[level][1])


def test_encode_batch_is_the_head_of_with_hints(two_blocks):
    args, want, base = two_blocks
    words, total = E.encode_batch(*args, 2, PHASE0)
    assert_same(words, want[2][0], "words")
    assert int(total) == int(want[2][1])
    offset_bits = E.encode_batch_with_offsets(*args, 2, PHASE0)
    for g, w in zip(offset_bits, base[2]):
        assert_same(g, w)


@pytest.mark.parametrize("level", LEVELS)
def test_emit_block_places_to_the_encode_words(two_blocks, level):
    args, _, base = two_blocks
    emit_args, bits = _stage_c_args(args, level)
    words = E.emit_block(*emit_args)
    assert words.shape == (2, E.WB)
    out, total = BM.merge_words(words, bits, 2 * E.WB)
    assert_same(out, base[level][0], f"L{level} placed words")
    assert int(total) == int(base[level][1])


@pytest.mark.parametrize("level", LEVELS)
def test_emit_block_packed_equals_emit_block(two_blocks, level):
    args, _, _ = two_blocks
    emit_args, _ = _stage_c_args(args, level)
    assert_same(E.emit_block_packed(*emit_args), E.emit_block(*emit_args),
                f"L{level} K7 route words")
