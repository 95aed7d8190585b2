"""Port vs reference: match finder, greedy parse, encoder planning, block
choice and bit assembly (ops/lz77.py, ops/bitmerge.py,
models/encoder.py stages A-B); kernel K9's design, greedy_parse_walk,
against the plain parse; the kernel wrappers of K9 and K10 refuse CPU
tensors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deflate_tpu.models import encoder as JE
from deflate_tpu.ops import bitmerge as JBM
from deflate_tpu.ops import lz77 as JLZ
from deflate_tpu_torch.models import encoder as E
from deflate_tpu_torch.ops import bitmerge as BM
from deflate_tpu_torch.ops import lz77 as LZ
from torch_helpers import (BLOCK, PARSE_CASES, PARSE_TILES, assert_same,
                           corpus, parse_case, search_blocks)


@pytest.fixture(scope="module")
def blocks():
    """Four blocks (text, repeats, words, random) with partial lengths."""
    data = np.frombuffer(corpus(4, seed=7), np.uint8).reshape(4, BLOCK)
    blens = np.array([BLOCK, BLOCK, 20000, 100], np.int32)
    data = data.copy()
    for b, n in enumerate(blens):
        data[b, n:] = 0
    return data, blens


def test_find_matches_and_parse_match_reference(blocks):
    data, blens = blocks
    jl, jd = jax.jit(jax.vmap(lambda b, n: JLZ.find_matches(
        b, n, 4, win_words=8, tiers=(), toofar3=256)))(
        jnp.asarray(data), jnp.asarray(blens))
    tl, td = LZ.find_matches(torch.from_numpy(data),
                             torch.from_numpy(blens), 4, win_words=8,
                             toofar3=256)
    assert_same(tl, jl, "match lengths")
    assert_same(td, jd, "match distances")
    jm, jlen = jax.jit(jax.vmap(lambda l, n: JLZ.greedy_parse(l, n)))(
        jl, jnp.asarray(blens))
    tm, tlen = LZ.greedy_parse(tl, torch.from_numpy(blens))
    assert_same(tm, jm, "token starts")
    assert_same(tlen, jlen, "parsed lengths")


def test_level3_find_matches_and_lazy_filter_match_reference(blocks):
    """Level 3's settings: tiered chains over 8- and 16-byte grams, K=48
    with 32-word windows, a per-block far-match cut (4096 on the full
    text block, 256 on the partial words block)."""
    data, blens = blocks
    data, blens = data[[0, 2]], blens[[0, 2]]
    cut = np.array([4096, 256], np.int32)
    jl, jd = jax.jit(jax.vmap(lambda b, n, f: JLZ.find_matches(
        b, n, 48, win_words=32, tiers=(2, 4), toofar3=f)))(
        jnp.asarray(data), jnp.asarray(blens), jnp.asarray(cut))
    tl, td = LZ.find_matches(torch.from_numpy(data),
                             torch.from_numpy(blens), 48, win_words=32,
                             tiers=(2, 4), toofar3=torch.from_numpy(cut))
    assert_same(tl, jl, "match lengths")
    assert_same(td, jd, "match distances")
    # the cut acts: length-3 matches farther than 256 only in block 0
    far3 = (tl == 3) & (td > 256)
    assert far3[0].any() and not far3[1].any()
    jfl, jfd = jax.vmap(JLZ.lazy_filter)(jl, jd)
    tfl, tfd = LZ.lazy_filter(tl, td)
    assert_same(tfl, jfl, "lazy lengths")
    assert_same(tfd, jfd, "lazy distances")
    assert (tfl == 0).sum() > (tl == 0).sum()


@pytest.mark.parametrize("level", [2, 3])
def test_find_matches_on_search_blocks_match_reference(level):
    """K10's test blocks (log lines, an all-zero block, blen 0-4, 131,
    BLOCK - 1 and BLOCK) through find_matches at level 2's and level 3's
    settings, level 3 with a far cut of 256 or 4096 by block, against
    the reference."""
    data, blens = search_blocks()
    if level == 2:
        K, W, tiers = E.L2_CANDS, E.L2_WIN_WORDS, ()
        cut = np.full(len(blens), E.L2_TOOFAR3, np.int32)
    else:
        K, W, tiers = E.L3_CANDS, E.L3_WIN_WORDS, E.L3_TIERS
        cut = np.where(np.arange(len(blens)) % 2, 4096, 256)
        cut = cut.astype(np.int32)
    jl, jd = jax.jit(jax.vmap(lambda b, n, f: JLZ.find_matches(
        b, n, K, win_words=W, tiers=tiers, toofar3=f)))(
        jnp.asarray(data), jnp.asarray(blens), jnp.asarray(cut))
    tl, td = LZ.find_matches(torch.from_numpy(data),
                             torch.from_numpy(blens), K, win_words=W,
                             tiers=tiers, toofar3=torch.from_numpy(cut))
    assert_same(tl, jl, "match lengths")
    assert_same(td, jd, "match distances")


@pytest.fixture(scope="module")
def parse_inputs():
    """parse_case by name, each computed once (level 3's find_matches
    takes seconds here)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = parse_case(name)
        return cache[name]
    return get


@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "greedy"])
@pytest.mark.parametrize("tile", PARSE_TILES)
@pytest.mark.parametrize("case", PARSE_CASES)
def test_greedy_parse_walk_matches_plain(parse_inputs, case, tile, lazy):
    """K9's token-start walk (greedy_parse_walk) against the plain
    tile-step loop, and greedy_parse on CPU tensors is the plain loop."""
    length, blen = parse_inputs(case)
    args = (torch.from_numpy(length), torch.from_numpy(blen), lazy, tile)
    want_mark, want_len = LZ.greedy_parse_plain(*args)
    got_mark, got_len = LZ.greedy_parse_walk(*args)
    assert_same(got_mark, want_mark, "token starts")
    assert_same(got_len, want_len, "parsed lengths")
    mark, len_adj = LZ.greedy_parse(*args)
    assert_same(mark, want_mark, "greedy_parse token starts")
    assert_same(len_adj, want_len, "greedy_parse lengths")
    # a block's token starts cover its blen bytes exactly
    covered = torch.where(want_mark, torch.clamp(want_len, min=1), 0).sum(1)
    assert_same(covered, np.clip(blen, 0, BLOCK), "bytes covered")


def test_greedy_parse_kernel_refuses_cpu_tensors():
    length, blen = parse_case("zeros")
    with pytest.raises(ValueError, match="CUDA"):
        LZ.greedy_parse_kernel(torch.from_numpy(length),
                               torch.from_numpy(blen))


@pytest.mark.parametrize("level", [1, 2])
def test_plan_matches_reference(blocks, level):
    data, blens = blocks
    jp = jax.jit(lambda b, n: JE.batch_plan(b, n, level))(
        jnp.asarray(data), jnp.asarray(blens))
    tp = E.batch_plan(torch.from_numpy(data), torch.from_numpy(blens),
                      level)
    for k in ("hist_lit", "hist_dist", "extra_total", "skey_l",
              "dyn_lit_lens", "dyn_dist_lens", "header_vals",
              "header_lens", "fixed_bits", "dyn_bits"):
        assert_same(tp[k], jp[k], k)
    for k in ("mark", "is_match", "lit_sym", "len", "dist", "lcode",
              "dcode", "ntok"):
        assert_same(tp["tk"][k], jp["tk"][k], "tk." + k)
    one = E.block_plan(torch.from_numpy(data[3]), torch.tensor(blens[3]),
                       level)
    for k in ("dyn_lit_lens", "header_vals", "fixed_bits", "dyn_bits"):
        assert_same(one[k], jp[k][3], "block_plan " + k)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_choose_blocks_matches_reference(level):
    rng = np.random.default_rng(level)
    B = 37
    fb = rng.integers(100, 270000, B).astype(np.int32)
    db = rng.integers(100, 270000, B).astype(np.int32)
    bl = rng.integers(0, BLOCK + 1, B).astype(np.int32)
    live = rng.random(B) < 0.9
    for phase0 in (0, 5, 13):
        want = JE.choose_blocks(jnp.asarray(fb), jnp.asarray(db),
                                jnp.asarray(bl), jnp.asarray(live), level,
                                phase0)
        got = E.choose_blocks(torch.from_numpy(fb), torch.from_numpy(db),
                              torch.from_numpy(bl), torch.from_numpy(live),
                              level, phase0)
        for g, w, name in zip(got, want, ("choice", "pad", "offset",
                                          "bits")):
            assert_same(g, w, name)


def _leaves(rng, B, S, wide: bool):
    """Random bit fields obeying the density bound (<=16 bits per leaf,
    48-bit leaves followed by two empty ones)."""
    sh = rng.integers(0, 17, (B, S)).astype(np.int32)
    if wide:
        big = np.arange(S) % 7 == 3
        sh[:, big] = 48
        sh[:, np.roll(big, 1)] = 0
        sh[:, np.roll(big, 2)] = 0
    lo = rng.integers(0, 1 << 32, (B, S), dtype=np.uint64)
    hi = rng.integers(0, 1 << 16, (B, S), dtype=np.uint64)
    lo = np.where(sh >= 32, lo, lo & ((np.uint64(1) << sh.astype(np.uint64))
                                      - np.uint64(1)))
    hi = np.where(sh > 32, hi & ((np.uint64(1) << np.maximum(
        sh - 32, 0).astype(np.uint64)) - np.uint64(1)), 0)
    return (lo.astype(np.uint32).view(np.int32),
            hi.astype(np.uint32).view(np.int32), sh)


@pytest.mark.parametrize("wide", [False, True], ids=["16bit", "48bit"])
def test_bit_assembly_matches_reference(wide):
    rng = np.random.default_rng(int(wide))
    B, S = 3, 1024
    lo, hi, sh = _leaves(rng, B, S, wide)
    kw = dict(leaf_bits=48 if wide else 16, density=16,
              slack=32 if wide else 0, cap_bits=16 * S + 64)
    jw, jb = JBM.merge_bitstream(jnp.asarray(lo),
                                 jnp.asarray(hi) if wide else None,
                                 jnp.asarray(sh), **kw)
    tw, tb = BM.merge_bitstream(torch.from_numpy(lo),
                                torch.from_numpy(hi) if wide else None,
                                torch.from_numpy(sh), **kw)
    assert_same(tw, jw, "merged words")
    assert_same(tb, jb, "merged bits")

    # place_at: the merged rows at per-row bit offsets
    W = tw.shape[1] + 40
    base = rng.integers(-2**31, 2**31, (B, W)).astype(np.int32)
    off = rng.integers(0, 1000, B).astype(np.int32)
    jo, _ = JBM.place_at(jnp.asarray(base), None, jw, jnp.asarray(off),
                         max_off_bits=1023)
    to = BM.place_at(torch.from_numpy(base), tw, torch.from_numpy(off))
    assert_same(to, jo, "placed words")

    # merge_words: the rows concatenated at their bit lengths
    jm, jt = JBM.merge_words(jw[:2], jb[:2], 2 * jw.shape[1])
    tm, tt = BM.merge_words(tw[:2], tb[:2], 2 * tw.shape[1])
    assert_same(tm, jm, "stream words")
    assert int(tt) == int(jt)


def test_lag_search_kernel_refuses_cpu_tensors():
    data, blens = search_blocks()
    skey = torch.arange(BLOCK, dtype=torch.int32).expand(len(blens), -1)
    with pytest.raises(ValueError, match="CUDA"):
        LZ.lag_search_kernel(torch.from_numpy(data), skey,
                             torch.from_numpy(blens), 4, 8, 256)
