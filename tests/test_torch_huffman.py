"""Port vs reference: Huffman code lengths, kernel K1's plain version,
canonical codes and the dynamic-header writer (ops/huffman.py,
ops/tree.py, ops/header.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deflate_tpu.ops import header as JHDR
from deflate_tpu.ops import huffman as JH
from deflate_tpu.ops import pallas_tree as JPT
from deflate_tpu_torch.ops import header as HDR
from deflate_tpu_torch.ops import huffman as H
from deflate_tpu_torch.ops import tree
from torch_helpers import assert_same


def _freqs(n: int, B: int, seed: int) -> np.ndarray:
    """Frequency batches covering the degenerate and overflow cases:
    random, empty, one used symbol, two, Fibonacci weights (deep trees:
    force the zlib length-limit fixup), flat."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 300, (B, n)).astype(np.int32)
    f[rng.random((B, n)) < 0.3] = 0
    f[1] = 0
    f[2] = 0
    f[2, n // 2] = 7
    f[3] = 0
    f[3, [1, n - 1]] = [5, 5]
    f[4] = 0
    fib = [1, 1]
    while len(fib) < 22:
        fib.append(fib[-1] + fib[-2])
    f[4, :min(n, 22)] = fib[:min(n, 22)]
    f[5] = 1
    return f


@pytest.fixture(scope="module", params=[(288, 15), (30, 15), (19, 7)],
                ids=["litlen", "dist", "cl"])
def alphabet(request):
    n, max_len = request.param
    return n, max_len, _freqs(n, 12, seed=n)


def test_depths_two_queue_matches_reference(alphabet):
    n, _, f = alphabet
    jlw, _, jnz = jax.vmap(JH._sort_leaves)(jnp.asarray(f))
    want_s, want_i = jax.vmap(JH._depths_two_queue)(jlw, jnz)
    lw, sperm, nz = H._sort_leaves(torch.from_numpy(f))
    assert_same(lw, jlw, "sorted weights")
    assert_same(nz, jnz, "nz")
    got_s, got_i = H._depths_two_queue(lw, nz)
    assert_same(got_s, want_s, "sorted leaf depths")
    assert_same(got_i, want_i, "internal depths")


def test_k1_plain_matches_depths_batch_interpret(alphabet):
    """tree.depths_batch on CPU tensors (K1's plain version, kernel
    layout) equals the Pallas kernel in interpret mode."""
    _, _, f = alphabet
    jlw, _, jnz = jax.vmap(JH._sort_leaves)(jnp.asarray(f))
    want_s, want_i = JPT.depths_batch(jlw, jnz, interpret=True)
    lw, _, nz = H._sort_leaves(torch.from_numpy(f))
    got_s, got_i = tree.depths_batch(lw, nz)
    assert_same(got_s, want_s, "leaf depths")
    assert_same(got_i, want_i, "internal depths")


def _jump_case(n: int) -> np.ndarray:
    """_freqs's rows, a deep row (Fibonacci weights over min(n, 36)
    symbols: a chain, the deepest leaves at nz - 1) and, at n = 512, a row
    using every symbol."""
    fib = [1, 1]
    while len(fib) < 36:
        fib.append(fib[-1] + fib[-2])
    deep = np.zeros((2, n), np.int32)
    deep[0, :min(n, 36)] = fib[:min(n, 36)]
    deep[1] = np.random.default_rng(n + 1).integers(1, 5000, n)
    return np.concatenate([_freqs(n, 12, seed=n), deep])


@pytest.mark.parametrize("n", [288, 30, 19, 512])
def test_k1_jump_matches_depths_batch_interpret(n):
    """tree.depths_jump (K1's design in torch) equals the Pallas kernel
    in interpret mode, leaf and internal depths."""
    f = _jump_case(n)
    jlw, _, jnz = jax.vmap(JH._sort_leaves)(jnp.asarray(f))
    want_s, want_i = JPT.depths_batch(jlw, jnz, interpret=True)
    lw, _, nz = H._sort_leaves(torch.from_numpy(f))
    got = tree.depths_jump(lw, nz)
    assert_same(got[:, :n], want_s, "leaf depths")
    assert_same(got[:, tree.NMAX:tree.NMAX + n], want_i, "internal depths")


@pytest.mark.parametrize("n", [288, 30, 19, 512])
def test_k1_jump_matches_plain(n):
    """depths_jump equals depths_plain on the whole [T, 1024] output,
    the zeros past nz included; the deep row reaches depth nz - 1."""
    lw, _, nz = H._sort_leaves(torch.from_numpy(_jump_case(n)))
    got = tree.depths_jump(lw, nz)
    assert_same(got, tree.depths_plain(lw, nz), "K1 layout")
    deep = len(nz) - 2
    assert int(got[deep, :n].max()) == int(nz[deep]) - 1


def test_code_lengths_match_reference(alphabet):
    n, max_len, f = alphabet
    want = JH.huffman_lengths_batch(jnp.asarray(f), max_len, "xla")
    got = H.huffman_lengths_batch(torch.from_numpy(f), max_len)
    assert_same(got, want, "batched lengths")
    assert_same(H.huffman_code_lengths(torch.from_numpy(f[0]), max_len),
                JH.huffman_code_lengths(jnp.asarray(f[0]), max_len),
                "single tree")


def test_canonical_codes_match_reference(alphabet):
    n, max_len, f = alphabet
    lens = np.array(JH.huffman_lengths_batch(jnp.asarray(f), max_len,
                                               "xla"))
    for row in lens[:6]:
        jc, _ = JH.canonical_codes(jnp.asarray(row))
        jr, jn = JH.canonical_parts(jnp.asarray(row))
        tc, _ = H.canonical_codes(torch.from_numpy(row))
        tr, tn = H.canonical_parts(torch.from_numpy(row))
        assert_same(tc, jc, "codes")
        assert_same(tr, jr, "ranks")
        assert_same(tn, jn, "next codes")


def test_dynamic_header_matches_reference():
    f_l = _freqs(288, 6, seed=5)
    f_l[:, 256] = np.maximum(f_l[:, 256], 1)          # EOB always used
    f_d = _freqs(30, 6, seed=6)
    ll = np.array(JH.huffman_lengths_batch(jnp.asarray(f_l), 15, "xla"))
    dl = np.array(JH.huffman_lengths_batch(jnp.asarray(f_d), 15, "xla"))
    ll[:, 286:] = 0
    # long zero and repeat runs for the 16/17/18 ops
    ll[0, 10:200] = 0
    ll[1, 20:60] = 8
    dl[2] = 0
    for b in range(len(ll)):
        jv, jl, jb = JHDR.emit_dynamic_header(jnp.asarray(ll[b]),
                                              jnp.asarray(dl[b]))
        tv, tl, tb = HDR.emit_dynamic_header(torch.from_numpy(ll[b]),
                                             torch.from_numpy(dl[b]))
        assert_same(tv, jv, f"header values {b}")
        assert_same(tl, jl, f"header lengths {b}")
        assert int(tb) == int(jb)
    jpre = jax.vmap(JHDR.header_pre)(jnp.asarray(ll), jnp.asarray(dl))
    tpre = HDR.header_pre(torch.from_numpy(ll), torch.from_numpy(dl))
    for k in ("sym", "extra_val", "extra_bits", "hlit", "hdist", "cl_hist"):
        assert_same(tpre[k], jpre[k], k)
