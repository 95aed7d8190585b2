"""Kernel K1: batched two-queue Huffman depth builds (csrc/tree.cu).

Replaces deflate_tpu/ops/pallas_tree.py (`_kernel`, wrapper
`depths_batch`).  Plain version: ops/huffman._depths_two_queue, masked
to the kernel's output layout (leaf depths valid for i < nz, internal
depths for k < nz - 1, zero elsewhere), which is all that
huffman._finish_lengths reads.
"""
from __future__ import annotations

import torch

from deflate_tpu_torch import _build
from deflate_tpu_torch.ops import huffman as H
from deflate_tpu_torch.utils.bits import I32

NMAX = 512                    # max leaves per tree
NW = 2 * NMAX                 # output words per tree
launches = 0


def depths_plain(lw: torch.Tensor, nz: torch.Tensor) -> torch.Tensor:
    """int32 [T, NW]: [0:NMAX) depth of the i-th sorted leaf (i < nz),
    [NMAX:NW) internal-node depths (k < nz - 1), zero elsewhere."""
    T, n = lw.shape
    sld, idep = H._depths_two_queue(lw, nz)
    ar = torch.arange(n, dtype=I32, device=lw.device)[None, :]
    out = torch.zeros((T, NW), dtype=I32, device=lw.device)
    out[:, :n] = torch.where(ar < nz[:, None], sld, 0)
    out[:, NMAX:NMAX + n] = torch.where(ar < nz[:, None] - 1, idep, 0)
    return out


def depths_kernel(lw: torch.Tensor, nz: torch.Tensor) -> torch.Tensor:
    """K1 on the card: same contract as depths_plain."""
    global launches
    lw = lw.to(I32).contiguous()
    nz = nz.to(I32).contiguous()
    dev = _build.require_cuda(lw, nz)
    T, n = lw.shape
    if n > NMAX or nz.shape != (T,):
        raise ValueError(f"bad tree batch {tuple(lw.shape)} / {nz.shape}")
    out = torch.empty((T, NW), dtype=I32, device=dev)
    if T:
        err = _build.lib("tree").dt_tree_depths(
            lw.data_ptr(), nz.data_ptr(), out.data_ptr(), T, n,
            _build.stream_ptr(dev))
        _build.check(err, "dt_tree_depths")
        launches += 1
    return out


def depths_batch(lw: torch.Tensor, nz: torch.Tensor):
    """Huffman depths for T trees: lw int32 [T, n] sorted leaf weights
    (INF past nz), nz int32 [T].  Returns (sorted_leaf_depth [T, n],
    idepth [T, n]) in the K1 layout.  CUDA tensors run K1; CPU tensors
    the plain version."""
    n = lw.shape[1]
    out = (depths_kernel(lw, nz) if lw.is_cuda else depths_plain(lw, nz))
    return out[:, :n], out[:, NMAX:NMAX + n]
