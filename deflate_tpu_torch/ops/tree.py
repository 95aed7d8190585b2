"""Kernel K1: batched two-queue Huffman depth builds (csrc/tree.cu).

Replaces deflate_tpu/ops/pallas_tree.py (`_kernel`, wrapper
`depths_batch`).  Plain version: ops/huffman._depths_two_queue, masked
to the kernel's output layout (leaf depths valid for i < nz, internal
depths for k < nz - 1, zero elsewhere), which is all that
huffman._finish_lengths reads.  `depths_jump` is the torch form of the
kernel's design: the merge two picks a step with each queue's first
two weights held apart, the parent links by a prefix sum, and the
depths by pointer jumping.
"""
from __future__ import annotations

import functools

import torch

from deflate_tpu_torch import _build
from deflate_tpu_torch.ops import huffman as H
from deflate_tpu_torch.utils.bits import I32

NMAX = 512                    # max leaves per tree
NW = 2 * NMAX                 # output words per tree
JUMP_ROUNDS = 9               # 2**9 > nz - 2, the deepest internal node
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


def depths_jump(lw: torch.Tensor, nz: torch.Tensor) -> torch.Tensor:
    """Same contract as depths_plain, computed as csrc/tree.cu does.

    The merge runs a step (two picks) at a time with the first two
    weights of the leaf queue (l0, l1) and of the internal queue (h0,
    h1) apart from the arrays, as the kernel keeps them in registers.
    Both queues are sorted, so a step takes c = [l0 <= h1] + [l1 <= h0]
    leaves (ties go to the leaf) and 2 - c internal nodes, and makes a
    node of weight min(l0, h0) + min(max(l0, h0), min(l1, h1)); the
    queues shift by what was taken and refill from the arrays (the
    internal array holds INF where no node is made yet), and the new node
    goes into the slot of its place in the queue.  The parent links come
    from a prefix sum of the steps' c; then every internal node finds its
    depth by pointer jumping (JUMP_ROUNDS rounds; a node whose pointer
    reaches the root, or a node >= nz - 1, stops), and every leaf reads
    its parent's depth."""
    T, n = lw.shape
    dev = lw.device
    inf = H._INF
    i64 = torch.int64
    nz = nz.to(i64).clamp(0, n)
    nint = nz - 1
    rows = torch.arange(T, device=dev)
    lws = torch.full((T, n + 8), inf, dtype=I32, device=dev)
    lws[:, :n] = lw
    iws = torch.full((T, n + 8), inf, dtype=I32, device=dev)
    steps = max(int(nint.max()) if T else 0, 0)
    cs = torch.zeros((T, steps), dtype=i64, device=dev)
    li = torch.zeros(T, dtype=i64, device=dev)
    ii = torch.zeros(T, dtype=i64, device=dev)
    l0, l1 = lws[:, 0], lws[:, 1]
    h0 = h1 = torch.full((T,), inf, dtype=I32, device=dev)

    def sel3(s, a, b, c):
        return torch.where(s == 0, a, torch.where(s == 1, b, c))

    for k in range(steps):
        act = k < nint
        L2, L3 = lws[rows, li + 2], lws[rows, li + 3]
        I2, I3 = iws[rows, ii + 2], iws[rows, ii + 3]
        c = torch.where(act, (l0 <= h1).to(i64) + (l1 <= h0).to(i64), 0)
        w = torch.minimum(l0, h0) + torch.minimum(
            torch.maximum(l0, h0), torch.minimum(l1, h1))
        iws[rows, torch.where(act, k, n + 7)] = w
        cs[:, k] = c
        d = torch.where(act, 2 - c, 0)
        l0, l1 = sel3(c, l0, l1, L2), sel3(c, l1, L2, L3)
        nh0, nh1 = sel3(d, h0, h1, I2), sel3(d, h1, I2, I3)
        li, ii = li + c, ii + d
        p = torch.where(act, k - ii, -1)       # node k's place in its queue
        h0 = torch.where(p == 0, w, nh0)
        h1 = torch.where(p == 1, w, nh1)

    ks = torch.arange(steps, device=dev)[None, :]
    live_k = ks < nint[:, None]
    lk = torch.cumsum(cs, 1) - cs              # leaves before step k
    ik = 2 * ks - lk                           # internal nodes before it
    lpar = torch.zeros((T, n + 1), dtype=I32, device=dev)  # column n: trash
    ipar = torch.zeros((T, n + 1), dtype=I32, device=dev)
    kv = ks.expand(T, steps).to(I32)
    for j in (0, 1):
        lpar.scatter_(1, torch.where(live_k & (cs > j), lk + j, n), kv)
        ipar.scatter_(1, torch.where(live_k & (2 - cs > j), ik + j, n), kv)

    kk = torch.arange(n, device=dev)[None, :]
    live = kk < nint[:, None]
    root = kk == (nint - 1)[:, None]
    anc = torch.where(root, kk, ipar[:, :n].to(i64).clamp(
        max=NMAX - 1))
    dist = (live & ~root).to(I32)
    for _ in range(JUMP_ROUNDS):
        go = live & (anc < (nint - 1)[:, None])
        a = anc.clamp(max=n - 1)
        dist = torch.where(go, dist + dist.gather(1, a), dist)
        anc = torch.where(go, anc.gather(1, a), anc)
    idep = torch.where(live, dist, 0)
    p = lpar[:, :n].to(i64).clamp(max=NMAX - 1)
    sld = torch.where(p < nint[:, None], idep.gather(1, p.clamp(max=n - 1)),
                      0) + 1
    out = torch.zeros((T, NW), dtype=I32, device=dev)
    out[:, :n] = torch.where(kk < nz[:, None], sld, 0)
    out[:, NMAX:NMAX + n] = idep
    return out


@functools.lru_cache(maxsize=None)
def _entry():
    """The ctypes function of dt_tree_depths, resolved once."""
    return _build.lib("tree").dt_tree_depths


def depths_launch(lw: torch.Tensor, nz: torch.Tensor,
                  out: torch.Tensor) -> None:
    """dt_tree_depths alone on checked operands (lw int32 [T, n], nz
    int32 [T], contiguous on one card) into a preallocated out [T, NW]."""
    T, n = lw.shape
    _build.check(_entry()(lw.data_ptr(), nz.data_ptr(), out.data_ptr(), T,
                          n, _build.stream_ptr(lw.device)),
                 "dt_tree_depths")


def depths_kernel(lw: torch.Tensor, nz: torch.Tensor) -> torch.Tensor:
    """K1 on the card: same contract as depths_plain."""
    global launches
    if lw.dtype != I32 or nz.dtype != I32 or not lw.is_contiguous() \
            or not nz.is_contiguous():
        lw, nz = lw.to(I32).contiguous(), nz.to(I32).contiguous()
    dev = lw.device
    if dev.type != "cuda" or nz.device != dev:
        raise ValueError(f"expected CUDA tensors on one device, got "
                         f"{dev} and {nz.device}")
    T, n = lw.shape
    if n > NMAX or nz.shape != (T,):
        raise ValueError(f"bad tree batch {tuple(lw.shape)} / {nz.shape}")
    out = torch.empty((T, NW), dtype=I32, device=dev)
    if T:
        depths_launch(lw, nz, out)
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
