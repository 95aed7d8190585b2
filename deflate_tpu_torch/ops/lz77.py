"""LZ77 match finding and greedy parsing for 32 KiB blocks, batched.

Port of deflate_tpu/ops/lz77.py: sorted-adjacent hash-chain candidates
(K per chain), window-word comparison, tiered hash chains over longer
grams, the merge-extension to 258 bytes, the tile-local greedy parse and
lazy_filter.  The sort keys ``(hash << 15) | pos`` are unique, so
``torch.sort`` plus a gather of each window word reproduces the
reference's multi-operand sort (stable or not) exactly, and the position
restore is a scatter by position.
"""
from __future__ import annotations

import torch

from deflate_tpu_torch.utils.bits import I32, I64, M32, u32, wrap32
from deflate_tpu_torch.utils.tables import MAX_MATCH, MIN_MATCH

WIN_WORDS = 8                    # 32-byte comparison window
TILE = 512                       # parse tile size


def _shift_back(a: torch.Tensor, k: int, fill) -> torch.Tensor:
    """a[..., i-k] with `fill` for i < k."""
    pad = torch.full(a.shape[:-1] + (k,), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([pad, a[..., :-k]], -1)


def _shift_fwd(a: torch.Tensor, k: int, fill) -> torch.Tensor:
    """a[..., i+k] with `fill` past the end."""
    pad = torch.full(a.shape[:-1] + (k,), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a[..., k:], pad], -1)


def _hash15(tri: torch.Tensor) -> torch.Tensor:
    """32-bit value (int64) -> 15-bit bucket; shift/xor/add mixing."""
    t = tri
    t = t ^ (t >> 13)
    t = (t + (t << 7)) & M32
    t = t ^ (t >> 9)
    return (t & 0x7FFF).to(I32)


def _aligned_words(block: torch.Tensor) -> torch.Tensor:
    """uint8 [B, n] -> little-endian u32 words (int64) at bytes 0,4,8.."""
    b4 = block.to(I64).reshape(block.shape[0], -1, 4)
    return b4[..., 0] | (b4[..., 1] << 8) | (b4[..., 2] << 16) | \
        (b4[..., 3] << 24)


def _window_words(block: torch.Tensor, win_words: int) -> torch.Tensor:
    """Phase-major window words int32 [win_words, B, n]: word j at byte
    4i+p is (w[i+j] >> 8p) | (w[i+j+1] << (32-8p)), the four phases
    concatenated (positions 4i+p in phase-major order)."""
    B, n = block.shape
    w = _aligned_words(block)                           # [B, n/4] int64
    wsh = [w] + [_shift_fwd(w, j, 0) for j in range(1, win_words + 1)]
    out = torch.empty((win_words, B, n), dtype=I32, device=block.device)
    for j in range(win_words):
        phases = [wsh[j]] + [((wsh[j] >> (8 * p))
                              | (wsh[j + 1] << (32 - 8 * p))) & M32
                             for p in range(1, 4)]
        out[j] = wrap32(torch.cat(phases, 1))
    return out


def _tier_hash(wins: torch.Tensor, g: int) -> torch.Tensor:
    """Bucket of the 4g-byte gram at each position: window word j rotated
    left by 5j, xor-folded (the reference's uint32 rotation, in int64)."""
    m = u32(wins[0])
    for j in range(1, g):
        x = u32(wins[j])
        m = m ^ (((x << (5 * j)) & M32) | (x >> (32 - 5 * j)))
    return _hash15(m)


def _lag_lengths(sw: torch.Tensor, k: int) -> torch.Tensor:
    """Match length (0..4*W) of each sorted lane against the lane k before
    it, from the co-sorted window words sw int32 [W, B, n]: whole equal
    words up to the first differing one, plus that word's equal low
    bytes."""
    W = sw.shape[0]
    x = torch.cat([sw[..., :k], sw[..., k:] ^ sw[..., :-k]], -1)
    ne = x != 0
    anyne = ne.any(0)
    first = ne.to(torch.uint8).argmax(0)               # first differing
    Lw = torch.where(anyne, first.to(I32), W)
    xw = torch.gather(x, 0, first[None])[0]
    xw = torch.where(anyne, xw, 0)
    lsb = xw & -xw
    part = torch.where(xw == 0, 0,
           torch.where((lsb & 0xFF) != 0, 0,
           torch.where((lsb & 0xFF00) != 0, 1,
           torch.where((lsb & 0xFF0000) != 0, 2, 3))))
    return 4 * Lw + part.to(I32)


def _tier_pass(h, valid, pos_pm, wins, blen, num_cands: int, toofar3):
    """One hash-chain pass: sort by (h, pos), compare the K lagged
    windows, keep the longest (the nearest on ties), restore position
    order.  Returns (length, dist) int32 [B, n]."""
    key = torch.where(valid, (h << 15) | pos_pm, (1 << 30) + pos_pm)
    skey, perm = torch.sort(key, dim=1)
    sw = torch.gather(wins, 2, perm[None].expand_as(wins))
    spos = skey & 0x7FFF
    shash = skey >> 15
    svalid = (skey < (1 << 30)).to(I32)
    slimit = torch.clamp(blen[:, None] - spos, max=MAX_MATCH)

    best_l = torch.zeros_like(spos)
    best_d = torch.zeros_like(spos)
    for k in range(1, num_cands + 1):
        same = ((shash == _shift_back(shash, k, -1)).to(I32) * svalid
                * _shift_back(svalid, k, 0))
        dist = spos - _shift_back(spos, k, 0)
        L = torch.minimum(_lag_lengths(sw, k), slimit) * same
        L = torch.where((L == MIN_MATCH) & (dist > toofar3), 0, L)
        better = L > best_l
        best_l = torch.where(better, L, best_l)
        best_d = torch.where(better, dist, best_d)
    del sw
    # restore position order (spos is a permutation of 0..n-1)
    sp = spos.to(I64)
    return (torch.zeros_like(best_l).scatter(1, sp, best_l),
            torch.zeros_like(best_d).scatter(1, sp, best_d))


def find_matches(block: torch.Tensor, blen: torch.Tensor,
                 num_cands: int = 4, win_words: int = WIN_WORDS,
                 tiers: tuple = (), toofar3=256):
    """Best match (length, distance) at every position of each block.

    block: uint8 [B, n] (zero padding past blen); blen: int32 [B];
    num_cands: chain depth K; win_words: comparison window in 32-bit
    words; tiers: extra passes hashing 4g-byte grams (g in tiers);
    toofar3: drop length-3 matches farther than this — an int or int32
    [B] per block.  Returns (length, dist) int32 [B, n], zero where no
    match >= 3.
    """
    B, n = block.shape
    dev = block.device
    nw = n // 4
    wins = _window_words(block, win_words)              # [W, B, n]
    iw = torch.arange(nw, dtype=I32, device=dev)
    pos_pm = torch.cat([4 * iw + p for p in range(4)])[None, :]
    valid = pos_pm < (blen[:, None] - (MIN_MATCH - 1))
    tf = torch.as_tensor(toofar3, dtype=I32, device=dev).reshape(-1, 1)

    def tier(h):
        return _tier_pass(h, valid, pos_pm, wins, blen, num_cands, tf)

    length, dist = tier(_hash15(u32(wins[0]) & 0x00FFFFFF))
    for g in tiers:
        tl, td = tier(_tier_hash(wins, g))
        better = (tl > length) | ((tl == length) & (td > 0)
                                  & ((dist == 0) | (td < dist)))
        length = torch.where(better, tl, length)
        dist = torch.where(better, td, dist)
    del wins

    # ---- merge-extension: compose verified window-sized pieces --------
    cap = 4 * win_words
    ar = torch.arange(n, dtype=I32, device=dev)[None, :]
    limit = torch.clamp(torch.clamp(blen[:, None] - ar, max=MAX_MATCH),
                        min=0)
    nxt_d = _shift_fwd(dist, cap, 0)
    nxt_l = _shift_fwd(length, cap, 0)
    linked = ((length == cap) & (dist > 0) & (nxt_d == dist)
              & (nxt_l > 0)).to(I32)
    c = linked
    alll = linked
    for r in range(3):
        s = cap * (1 << r)
        c = c + alll * _shift_fwd(c, s, 0)
        alll = alll * _shift_fwd(alll, s, 0)
    c = torch.clamp(c, max=8)
    tail = torch.zeros_like(length)
    for hops in range(9):
        tl = length if hops == 0 else _shift_fwd(length, cap * hops, 0)
        td = dist if hops == 0 else _shift_fwd(dist, cap * hops, 0)
        if hops:
            tl = torch.where(td == dist, tl, 0)
        tail = torch.where(c == hops, tl, tail)
    merged = torch.where(length == cap, cap * c + tail, length)
    length = torch.minimum(torch.maximum(length, merged), limit)

    usable = length >= MIN_MATCH
    return (torch.where(usable, length, 0).to(I32),
            torch.where(usable, dist, 0).to(I32))


def lazy_filter(length: torch.Tensor, dist: torch.Tensor):
    """One-step lazy matching: drop the match at i when i+1 has a strictly
    longer one.  length, dist [..., n]."""
    keep = length >= _shift_fwd(length, 1, 0)
    return torch.where(keep, length, 0), torch.where(keep, dist, 0)


def greedy_parse(length: torch.Tensor, blen: torch.Tensor, lazy: bool = True,
                 tile: int = TILE):
    """Greedy tokenization within `tile`-byte tiles, sequential in the
    tile step and vectorized over tiles x blocks; one-step lazy deferral
    at token starts.  length [B, n], blen [B].  Returns (mark bool [B, n]
    token starts, len_adj int32 [B, n] match length used, 0 for
    literals)."""
    B, n = length.shape
    dev = length.device
    nt = n // tile
    nxt = _shift_fwd(length, 1, 0)
    Lt = length.reshape(B, nt, tile)
    Nx = nxt.reshape(B, nt, tile)
    base = (torch.arange(nt, dtype=I32, device=dev) * tile)[None, :]
    bl = blen[:, None]
    p = base.expand(B, nt).clone()
    marks, lens = [], []
    for t in range(tile):
        pos = base + t
        emit = (p == pos) & (pos < bl)
        ml = torch.minimum(torch.clamp(Lt[:, :, t], max=tile - t), bl - pos)
        use = emit & (ml >= MIN_MATCH)
        if lazy:
            nx_t = torch.minimum(torch.clamp(Nx[:, :, t], max=tile - t - 1),
                                 bl - pos - 1)
            use = use & ~(nx_t > ml)
        p = p + torch.where(emit, torch.where(use, ml, 1), 0)
        marks.append(emit)
        lens.append(torch.where(use, ml, 0))
    mark = torch.stack(marks, 2).reshape(B, n)
    len_adj = torch.stack(lens, 2).reshape(B, n).to(I32)
    return mark, len_adj
