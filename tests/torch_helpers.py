"""Shared pieces of the deflate_tpu_torch tests (tests/test_torch_*.py).

Each test feeds one numpy input through the JAX reference (deflate_tpu,
on the CPU, Pallas kernels in interpret mode) and through its port, and
compares integer outputs exactly.  Tests marked ``cuda`` hold a CUDA
kernel against its plain version and skip without a card.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench import make_corpus  # noqa: E402

# test files run in parallel worker processes; keep each to a few threads
torch.set_num_threads(2)

BLOCK = 32768


def corpus(nblocks: int, seed: int = 42) -> bytes:
    """The benchmark corpus at nblocks x 32 KiB (text, repeats, words,
    random quarters)."""
    return make_corpus(np.random.default_rng(seed), nblocks * BLOCK)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def np_i32(x) -> np.ndarray:
    """A torch or JAX array as a numpy int32 array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.int32)
    return np.asarray(x).astype(np.int32)


def assert_same(got, want, what: str = "") -> None:
    g, w = np_i32(got), np_i32(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    bad = np.argwhere(g != w)
    assert len(bad) == 0, (what, len(bad), bad[:5].tolist(),
                           g[tuple(bad[0])], w[tuple(bad[0])])


NM = 11264                  # match-record slots per block


def monotone_instance(rng, B, L, left):
    """Random routing instance: compaction (left) or spreading (right),
    two payloads, destinations strictly increasing."""
    delta = np.full((B, L), -1, np.int32)
    for b in range(B):
        occ = np.sort(rng.choice(L, size=int(rng.integers(1, L // 3)),
                                 replace=False))
        if left:
            dest = np.arange(len(occ))
        else:
            dest = occ + np.sort(rng.integers(0, 4, len(occ)).cumsum())
            keep = dest < L
            occ, dest = occ[keep], dest[keep]
        delta[b, occ] = np.abs(dest - occ)
    pays = [rng.integers(-2**31, 2**31, (B, L)).astype(np.int32)
            for _ in range(2)]
    return pays, delta


def fill_case(B):
    """Every distance class (1, 2, 3 periodic; 4-8 overlapping; far),
    every word phase, short and long lengths (the reference's
    adversarial fill test)."""
    rng = np.random.default_rng(11)
    lit = rng.integers(-2**31, 2**31, (B, 8192), dtype=np.int64)
    lit = lit.astype(np.int32)
    rec0 = np.zeros((B, NM), np.int32)
    rec1 = np.zeros((B, NM), np.int32)
    nmatch = np.zeros(B, np.int32)
    cases = []
    o = 16
    for dist in (1, 2, 3, 4, 5, 6, 7, 8, 31, 509):
        for ln in (3, 4, 7, 15, 16, 17, 29, 258):
            for phase in range(4):
                cases.append((o + phase, ln, dist))
                o += ln + phase + 11
    per = len(cases) // B + 1
    for b in range(B):
        sub = cases[b * per:(b + 1) * per]
        for m, (o_, ln, d) in enumerate(sub):
            rec0[b, m] = (o_ & 0xFFFF) | ((ln - 3) << 16)
            rec1[b, m] = d
        nmatch[b] = len(sub)
    return lit, rec0, rec1, nmatch
