"""Canonical Huffman codes and length-limited code lengths, batched.

Port of deflate_tpu/ops/huffman.py.  Every function takes a leading batch
dimension where the reference vmaps.  The tie-breaks (leaf queue first on
equal weights, frequency-then-symbol leaf order, zlib's overflow fixup)
are the reference's, so lengths agree bit for bit.
"""
from __future__ import annotations

import torch

from deflate_tpu_torch.utils import metrics
from deflate_tpu_torch.utils.bits import I32, I64
from deflate_tpu_torch.utils.tables import MAX_CODE_LEN

_INF = 1 << 28


def bit_reverse(value: torch.Tensor, nbits: torch.Tensor) -> torch.Tensor:
    """Reverse the low `nbits` (<=16) bits of each element."""
    v = value.to(I32)
    v = ((v & 0x5555) << 1) | ((v >> 1) & 0x5555)
    v = ((v & 0x3333) << 2) | ((v >> 2) & 0x3333)
    v = ((v & 0x0F0F) << 4) | ((v >> 4) & 0x0F0F)
    v = ((v & 0x00FF) << 8) | ((v >> 8) & 0x00FF)
    n = nbits.to(I32)
    return torch.where(n > 0, v >> (16 - torch.clamp(n, max=16)),
                       torch.zeros_like(v))


def _next_codes(bl_count: torch.Tensor) -> torch.Tensor:
    """RFC 1951 §3.2.2 next_code: bl_count [..., 15] -> [..., 16]."""
    codes = [torch.zeros_like(bl_count[..., 0])]
    code = codes[0]
    prev = codes[0]
    for l in range(1, MAX_CODE_LEN + 1):
        code = (code + prev) << 1
        codes.append(code)
        prev = bl_count[..., l - 1]
    return torch.stack(codes, dim=-1)


def canonical_parts(lengths: torch.Tensor):
    """(rank-within-length [..., n], next_code [..., 16]) for lengths
    [..., n]; code(sym) = next_code[len] + rank."""
    L = torch.arange(1, MAX_CODE_LEN + 1, dtype=I32, device=lengths.device)
    onehot = (lengths[..., :, None] == L).to(I32)            # [..., n, 15]
    bl_count = onehot.sum(dim=-2).to(I32)
    next_code = _next_codes(bl_count)
    rank = (torch.cumsum(onehot, dim=-2) - onehot).to(I32)
    li = torch.clamp(lengths - 1, 0, MAX_CODE_LEN - 1).to(I64)
    rank_i = torch.gather(rank, -1, li[..., None])[..., 0]
    return rank_i, next_code


def canonical_codes(lengths: torch.Tensor):
    """(bit-reversed canonical codes, lengths) for lengths [..., n]."""
    rank_i, next_code = canonical_parts(lengths)
    nc = torch.gather(next_code, -1,
                      torch.clamp(lengths, 0, MAX_CODE_LEN).to(I64))
    code = torch.where(lengths > 0, nc + rank_i, torch.zeros_like(nc))
    return bit_reverse(code, lengths), lengths


def decode_tables(lengths: torch.Tensor):
    """Canonical-decode vectors of one code, lengths int32 [n]: first[l]
    (first code of length l), lim[l] (first + count), base[l] (symbols
    of length < l), count[l], all int32 [16], and syms int32 [n], the
    symbols by (length, symbol) with unused ones last.  The sort keys
    are unique, so the stable argsort only pins the tie rule down."""
    n = lengths.shape[0]
    dev = lengths.device
    L = torch.arange(1, MAX_CODE_LEN + 1, dtype=I32, device=dev)
    counts = (lengths[:, None] == L).sum(0).to(I32)
    first = _next_codes(counts)
    cnt16 = torch.cat([torch.zeros(1, dtype=I32, device=dev), counts])
    idx = torch.arange(n, dtype=I32, device=dev)
    key = torch.where(lengths > 0, lengths * 1024 + idx, (1 << 30) + idx)
    return {"first": first, "lim": first + cnt16,
            "base": (torch.cumsum(cnt16, 0) - cnt16).to(I32),
            "syms": torch.argsort(key, stable=True).to(I32),
            "count": cnt16}


def decode_one(bits15: torch.Tensor, tbl):
    """Decode one canonical symbol from the next 15 stream bits (LSB
    first, int32 of any shape).  Returns (symbol, length) int32; length
    0 (symbol -1) marks an invalid code.  The reference's 15 compare /
    select rounds run side by side on a last axis of 15 lengths; the
    shortest length that holds the code wins, as the first hit does
    there."""
    dev = bits15.device
    L = torch.arange(1, MAX_CODE_LEN + 1, dtype=I32, device=dev)
    # the first l bits, first bit most significant
    c = bit_reverse(bits15[..., None] & ((1 << L) - 1), L)
    first, lim = tbl["first"][1:], tbl["lim"][1:]
    hit = (tbl["count"][1:] > 0) & (c >= first) & (c < lim)
    l0 = torch.where(hit, L - 1, MAX_CODE_LEN).min(-1).values
    found = l0 < MAX_CODE_LEN
    l0 = l0.clamp(max=MAX_CODE_LEN - 1)[..., None].to(I64)
    pos = (tbl["base"][1:] + c - first).gather(-1, l0)[..., 0]
    nsyms = tbl["syms"].shape[0]
    sym = tbl["syms"][pos.clamp(0, nsyms - 1).to(I64)]
    return (torch.where(found, sym, -1).to(I32),
            torch.where(found, l0[..., 0] + 1, 0).to(I32))


def _sort_leaves(freq: torch.Tensor):
    """freq [B, n] -> (lw sorted weights, sperm symbol order, nz [B]):
    ascending by (frequency, symbol), unused symbols as an INF tail."""
    n = freq.shape[-1]
    idx = torch.arange(n, dtype=I64, device=freq.device)
    wkey = torch.where(freq > 0, freq.to(I64), _INF)
    key = torch.sort((wkey << 10) | idx, dim=-1).values
    return ((key >> 10).to(I32), (key & 1023).to(I32),
            (freq > 0).sum(-1).to(I32))


def _depths_two_queue(lw: torch.Tensor, nz: torch.Tensor):
    """Two-queue Huffman merge over presorted leaf weights lw [B, n]
    (INF past nz) — the plain version of kernel K1 (ops/tree.py).

    Returns (sorted_leaf_depth [B, n], idepth [B, n]) exactly as the
    reference computes them, including its values past nz."""
    B, n = lw.shape
    dev = lw.device
    rows = torch.arange(B, device=dev)
    iw = torch.full((B, n), _INF, dtype=I32, device=dev)
    lpar = torch.zeros((B, n), dtype=I32, device=dev)
    ipar = torch.zeros((B, n), dtype=I32, device=dev)
    li = torch.zeros(B, dtype=torch.int64, device=dev)
    ii = torch.zeros(B, dtype=torch.int64, device=dev)

    def pick(li, ii, lpar, ipar, k):
        wl = torch.where(li < n, lw[rows, li.clamp(max=n - 1)], _INF)
        wi = iw[rows, ii.clamp(max=n - 1)]
        take_leaf = wl <= wi
        w = torch.where(take_leaf, wl, wi)
        live = w < _INF
        tl, ti = take_leaf & live & (li < n), ~take_leaf & live & (ii < n)
        lpar = lpar.clone()
        ipar = ipar.clone()
        lpar[rows[tl], li[tl]] = k
        ipar[rows[ti], ii[ti]] = k
        li = li + (take_leaf & live).to(torch.int64)
        ii = ii + (~take_leaf & live).to(torch.int64)
        return li, ii, lpar, ipar, w

    for k in range(n - 1):
        li, ii, lpar, ipar, w1 = pick(li, ii, lpar, ipar, k)
        li2, ii2, lpar2, ipar2, w2 = pick(li, ii, lpar, ipar, k)
        do = w2 < _INF
        li = torch.where(do, li2, li)
        ii = torch.where(do, ii2, ii)
        lpar = torch.where(do[:, None], lpar2, lpar)
        ipar = torch.where(do[:, None], ipar2, ipar)
        iw[:, k] = torch.where(do, w1 + w2, _INF)

    nint = torch.clamp(nz - 1, min=1)
    idepth = torch.zeros((B, n), dtype=I32, device=dev)
    for j in range(n - 1):
        k = n - 2 - j
        par = ipar[:, k].clamp(0, n - 1).to(torch.int64)
        d = torch.where(nint - 1 == k, 0, idepth[rows, par] + 1)
        idepth[:, k] = torch.where(nint > k, d, 0)
    sld = torch.gather(idepth, 1, lpar.clamp(0, n - 1).to(torch.int64)) + 1
    return sld.to(I32), idepth


def _finish_lengths(freq, max_len: int, nz, sperm, sorted_leaf_depth,
                    idepth):
    """Unpermute depths, apply zlib's overflow fixup, reassign lengths.
    All operands batched [B, n] / [B]."""
    B, n = freq.shape
    dev = freq.device
    nint = torch.clamp(nz - 1, min=1)[:, None]
    ar = torch.arange(n, dtype=I32, device=dev)[None, :]
    leaf_depth = torch.zeros((B, n), dtype=I32, device=dev).scatter(
        1, sperm.to(I64), torch.where(ar < nz[:, None], sorted_leaf_depth,
                                      0).to(I32))
    depth = torch.cat([leaf_depth, torch.where(ar < nint, idepth, 0)], 1)

    used = freq > 0
    clamped = torch.clamp(leaf_depth, max=max_len)
    real = torch.cat([used, ar < nz[:, None] - 1], 1)
    ov = (real & (depth > max_len)).sum(1).to(I32)
    lrange = torch.arange(max_len + 1, dtype=I32, device=dev)
    bl = (used[:, None, :] & (clamped[:, None, :] == lrange[None, :, None])
          ).sum(2).to(I32)                                 # [B, max_len+1]
    rows = torch.arange(B, device=dev)
    while bool(metrics.to_host((ov > 0).any())):
        act = ov > 0
        cand = torch.where((lrange < max_len) & (bl > 0), lrange, -1)
        bits = cand.max(1).values.to(I64)
        upd = torch.zeros_like(bl)
        upd[rows, bits % (max_len + 1)] -= 1
        upd[rows, (bits + 1) % (max_len + 1)] += 2
        upd[:, max_len] -= 1
        bl = torch.where(act[:, None], bl + upd, bl)
        ov = torch.where(act, ov - 2, ov)
    bl[:, 0] = 0

    key = torch.where(used, -freq.to(I32) * 512 + ar, _INF + ar)
    order = torch.argsort(key, dim=1, stable=True)
    cum = torch.cumsum(bl, 1)
    r = ar.expand(B, n).to(I64)
    lbr = torch.searchsorted(cum[:, 1:].contiguous(), r.contiguous(),
                             right=True).to(I32) + 1
    lbr = torch.where(r < nz[:, None], lbr, 0).to(I32)
    lengths = torch.zeros((B, n), dtype=I32, device=dev).scatter(1, order,
                                                                 lbr)
    return torch.where((nz == 1)[:, None], used.to(I32), lengths)


def huffman_lengths_batch(freqs: torch.Tensor, max_len: int) -> torch.Tensor:
    """Length-limited Huffman code lengths for freqs int32 [B, n]
    (n <= 512).  The depth step is kernel K1 on CUDA tensors."""
    from deflate_tpu_torch.ops import tree

    lw, sperm, nz = _sort_leaves(freqs)
    sld, idep = tree.depths_batch(lw, nz)
    return _finish_lengths(freqs, max_len, nz, sperm, sld, idep)


def huffman_code_lengths(freq: torch.Tensor, max_len: int) -> torch.Tensor:
    """Single-tree form over freq [n], on the plain depth step."""
    f = freq[None]
    lw, sperm, nz = _sort_leaves(f)
    sld, idep = _depths_two_queue(lw, nz)
    return _finish_lengths(f, max_len, nz, sperm, sld, idep)[0]
