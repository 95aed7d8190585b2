"""The wavefront decode's stage C-F glue on the CPU: ops/wave.resolve_litval
and merge_match_runs take their plain versions for CPU tensors, and the
kernel wrappers (K11, K12) refuse what the kernels do not take before
building anything.  The kernels themselves are held against the plain
versions on the card, in tests/test_torch_cuda.py; the plain versions
against the JAX package in tests/test_torch_wave.py.
"""
import numpy as np
import pytest
import torch

from deflate_tpu_torch import _build
from deflate_tpu_torch.ops import wave as W
from deflate_tpu_torch.utils import metrics
from torch_helpers import MERGE_ROWS, assert_same, litval_case, merge_case


def _no_build(*args, **kw):
    raise AssertionError("a kernel library was built or loaded")


@pytest.fixture
def no_kernels(monkeypatch):
    """Fails the test if anything loads a kernel library; counters
    start at 0."""
    monkeypatch.setattr(_build, "lib", _no_build)
    W._glue_entry.cache_clear()
    metrics.reset()
    yield
    metrics.reset()


def _glue_operands(name):
    if name == "resolve_litval":
        return tuple(torch.from_numpy(a) for a in litval_case())
    return tuple(torch.from_numpy(a) for a in merge_case())


@pytest.mark.parametrize("name", ["resolve_litval", "merge_match_runs"])
def test_glue_takes_the_plain_route_on_cpu(name, no_kernels, monkeypatch):
    """CPU tensors run the plain version under the same span and launch
    no kernel: no library loads and kernel.K11 / K12 stay uncounted."""
    monkeypatch.setattr(W, name + "_kernel", _no_build)
    args = _glue_operands(name)
    got = getattr(W, name)(*args)
    want = getattr(W, name + "_plain")(*args)
    for g, w in zip(got if isinstance(got, tuple) else [got],
                    want if isinstance(want, tuple) else [want]):
        assert_same(g, w, name)
    counts = metrics.snapshot()["counts"]
    assert "kernel.K11" not in counts and "kernel.K12" not in counts


@pytest.mark.parametrize("name", ["resolve_litval", "merge_match_runs"])
def test_glue_kernels_refuse_cpu_tensors(name, no_kernels):
    with pytest.raises(ValueError, match="CUDA"):
        getattr(W, name + "_kernel")(*_glue_operands(name))


def test_merge_kernel_refuses_rows_off_the_tile(no_kernels):
    """K12's rounds run inside aligned tiles of 256 records: it refuses
    rows of other lengths (the plain version's reshape does too), and
    records of two shapes."""
    rec0, rec1 = (torch.from_numpy(a) for a in merge_case())
    with pytest.raises(ValueError, match="multiple of 256"):
        W.merge_match_runs_kernel(rec0[:, :300], rec1[:, :300])
    with pytest.raises(ValueError, match="multiple of 256"):
        W.merge_match_runs_kernel(rec0, rec1[:, :-256])
    with pytest.raises(ValueError, match="multiple of 256"):
        W.merge_match_runs_kernel(rec0[0], rec1[0])


def test_litval_kernel_refuses_bad_shapes(no_kernels):
    len_, r_rel, mask = (torch.from_numpy(a) for a in litval_case())
    for args in ((len_, r_rel[:, :-1], mask), (len_, r_rel, mask[:, :15]),
                 (len_[:2], r_rel[:2], mask), (len_[0, 0], r_rel[0, 0],
                                               mask)):
        with pytest.raises(ValueError, match="K11 takes"):
            W.resolve_litval_kernel(*args)


def test_resolve_litval_rows_of_any_rank():
    """One row a block, whatever the rank: [B, 4, n/4] lanes give the
    [B, n] answer, which K11 relies on when it flattens them."""
    len_, r_rel, mask = (torch.from_numpy(a) for a in litval_case())
    flat = W.resolve_litval_plain(len_, r_rel, mask)
    B, n = len_.shape
    deep = W.resolve_litval_plain(len_.reshape(B, 4, n // 4),
                                  r_rel.reshape(B, 4, n // 4), mask)
    assert_same(deep.reshape(B, n), flat, "rank 3")
    # where no word holds the rank, the select gives 31
    none = (len_ == 0) & (r_rel >= 0)
    assert bool(none.any()) and bool((flat[none] == 31).all())


def test_merge_rounds_stay_inside_tiles():
    """The plain merge never joins records of two aligned 256-record
    tiles: one chain through a full row ends as one record a tile, each
    holding the tile's 256 three-byte pieces.  K12 merges a tile at a
    time on this premise."""
    rec0, rec1 = (torch.from_numpy(a) for a in merge_case())
    full = MERGE_ROWS.index("full")
    o0, o1, nm = W.merge_match_runs_plain(rec0[full:full + 1],
                                          rec1[full:full + 1])
    tiles = W.NM // W.RUN_TILE
    assert int(nm[0]) == tiles
    opos = np.arange(tiles) * W.RUN_TILE * 3 & 0xFFFF
    assert_same(o0[0, :tiles], opos | ((W.RUN_TILE * 3 - 3) << 16), "runs")
    assert_same(o1[0, :tiles], np.ones(tiles), "dists")
    assert bool((o0[0, tiles:] == -1).all() and (o1[0, tiles:] == 0).all())
