"""Level 3's search, plain: the yardstick that holds a stream to its level.

For each 32 KiB block (batched over blocks, on any device, plain torch):

- candidates: at each position, the DEPTH nearest earlier positions in
  the block whose first 3 bytes are the same, the DEPTH nearest whose
  first 8 are, and the DEPTH nearest whose first 16 are (a gram exists
  where it lies inside the block); grams are compared exactly;
- length: the exact common prefix, cut at MAX_MATCH and at the block's
  end; the longest candidate is kept, the nearest on ties;
- far cut: a length-3 match farther than FAR_LOW (bytes of order-0
  entropy under ENTROPY_CUT bits) or FAR_HIGH (else) is dropped;
- parse: greedy within TILE-byte tiles, no token crossing a tile, with
  one-step lazy matching: a match at i (its length cut at the tile's
  end) is dropped when the one at i + 1 is strictly longer;
- size: the order-0 entropy, in bits, of the block's literal/length
  symbols (with end-of-block) and of its distance codes, plus their
  extra bits.

Departures from the port (deflate_tpu_torch/ops/lz77.py and
models/encoder.py), each of which leans towards a yardstick smaller than
what the port writes (the check's ceiling leaves room for them):

- exact grams, where the port groups positions by 15-bit hashes of them
  (so its chains can hold other grams and miss some of the same);
- exact lengths, where the port compares 128-byte windows and composes
  longer matches by its merge-extension;
- an entropy size, where the port writes real Huffman codes (limited to
  15 bits) and their block headers.

Written apart from the code under test: the chains are runs of a sort by
exact gram ids, the lengths come from binary lifting over ids of
2^k-byte grams, and the parse is reachability by pointer doubling over
each position's fixed successor.  It imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

N = 32768                      # block size
MIN_MATCH, MAX_MATCH = 3, 258
DEPTH = 48
GRAMS = (3, 8, 16)
TILE = 2048
FAR_LOW, FAR_HIGH = 4096, 256
ENTROPY_CUT = 3.5
LIFT = 9                       # 2^0 .. 2^8-byte grams: lengths to 511
PAD = 1 << LIFT                # bytes past a block that the lifting reads

# RFC 1951 3.2.5: length codes 257..285 and distance codes 0..29
LEN_BASE = (3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43,
            51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258)
LEN_EXTRA = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4,
             4, 4, 4, 5, 5, 5, 5, 0)
DIST_BASE = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257,
             385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289,
             16385, 24577)
DIST_EXTRA = (0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9,
              9, 10, 10, 11, 11, 12, 12, 13, 13)
EOB = 256


def _gram_ids(block: torch.Tensor) -> list[torch.Tensor]:
    """ids[k] int64 [S, N + PAD]: equal exactly where the 2^k bytes from
    two positions of one block are equal, the block read with zeros past
    its end (the lengths are cut at the end later); ids of different
    blocks never meet."""
    S = block.shape[0]
    dev = block.device
    row = torch.arange(S, device=dev)[:, None]
    padded = torch.zeros((S, N + PAD), dtype=torch.int64, device=dev)
    padded[:, :block.shape[1]] = block.to(torch.int64)
    ids = [row * 256 + padded]
    for k in range(1, LIFT):
        prev, h = ids[-1], 1 << (k - 1)
        nxt = torch.full_like(prev, -1)
        nxt[:, :-h] = prev[:, h:]
        key = prev * (int(prev.max()) + 2) + (nxt + 1)
        ids.append(torch.unique(key, return_inverse=True)[1])
    return ids


def _common(ids, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The longest common prefix (at most 2^LIFT - 1) of the bytes from
    positions a and b of each block (int64 [S, m])."""
    got = torch.zeros_like(a)
    for k in reversed(range(LIFT)):
        eq = ids[k].gather(1, a + got) == ids[k].gather(1, b + got)
        got = got + (eq.to(torch.int64) << k)
    return got


def _far_cut(block: torch.Tensor, blen: torch.Tensor) -> torch.Tensor:
    """int64 [S]: FAR_LOW where the order-0 entropy of the block's blen
    bytes is under ENTROPY_CUT bits, else FAR_HIGH."""
    S = block.shape[0]
    pos = torch.arange(block.shape[1], device=block.device)[None, :]
    live = (pos < blen[:, None]).to(torch.float64)
    cnt = torch.zeros((S, 256), dtype=torch.float64, device=block.device)
    cnt.scatter_add_(1, block.to(torch.int64), live)
    p = cnt / blen.clamp(min=1).to(torch.float64)[:, None]
    ent = -(p * torch.log2(torch.where(p > 0, p, 1.0))).sum(1)
    return torch.where(ent < ENTROPY_CUT, FAR_LOW, FAR_HIGH)


def search(block: torch.Tensor, blen: torch.Tensor):
    """The best match at every position: (length, dist) int64 [S, N], 0
    where none.  block uint8 [S, N] (zeros past blen); blen [S]."""
    S = block.shape[0]
    dev = block.device
    blen = blen.to(torch.int64).to(dev)
    ids = _gram_ids(block)
    pos = torch.arange(N, device=dev).expand(S, N)
    limit = torch.clamp(blen[:, None] - pos, 0, MAX_MATCH)
    far = _far_cut(block, blen)[:, None]
    raw = ids[0] - 256 * torch.arange(S, device=dev)[:, None]
    tri = (torch.arange(S, device=dev)[:, None] << 24) | raw[:, :N] | (
        raw[:, 1:N + 1] << 8) | (raw[:, 2:N + 2] << 16)
    best_l = torch.zeros((S, N), dtype=torch.int64, device=dev)
    best_d = torch.zeros_like(best_l)
    for g, gid in zip(GRAMS, (tri, ids[3][:, :N], ids[4][:, :N])):
        valid = pos + g <= blen[:, None]
        top = int(gid.max()) + 1
        key = torch.where(valid, gid, top) * N + pos
        skey = torch.sort(key, 1).values
        sgid, spos = skey // N, skey % N
        for k in range(1, DEPTH + 1):
            same = torch.zeros_like(valid)
            same[:, k:] = (sgid[:, k:] == sgid[:, :-k]) & (sgid[:, k:] < top)
            there = torch.zeros_like(spos)
            there[:, k:] = spos[:, :-k]
            length = torch.minimum(_common(ids, there, spos),
                                   limit.gather(1, spos))
            dist = spos - there
            length = torch.where(
                same & (length >= MIN_MATCH)
                & ~((length == MIN_MATCH) & (dist > far)), length, 0)
            cur_l, cur_d = best_l.gather(1, spos), best_d.gather(1, spos)
            better = (length > cur_l) | ((length == cur_l) & (length > 0)
                                         & (dist < cur_d))
            # a sorted row holds each position once: one writer each
            best_l.scatter_(1, spos, torch.where(better, length, cur_l))
            best_d.scatter_(1, spos, torch.where(better, dist, cur_d))
    return best_l, best_d


def parse(length: torch.Tensor, blen: torch.Tensor):
    """The lazy greedy parse of search()'s lengths: (start bool [S, N],
    taken int64 [S, N]: the match length used at a token start, 0 for a
    literal and off starts)."""
    S = length.shape[0]
    dev = length.device
    blen = blen.to(torch.int64).to(dev)
    pos = torch.arange(N, device=dev).expand(S, N)
    room = torch.minimum(TILE - pos % TILE, blen[:, None] - pos)
    ml = torch.minimum(length, room)
    nx = torch.zeros_like(ml)
    nx[:, :-1] = torch.minimum(length[:, 1:], room[:, :-1] - 1)
    take = (ml >= MIN_MATCH) & ~(nx > ml)
    taken = torch.where(take, ml, 0)
    # each position's successor were it a token start; N: none
    succ = pos + torch.where(take, ml, 1)
    succ = torch.where(succ < blen[:, None], succ, N)
    succ = torch.cat([succ, torch.full((S, 1), N, device=dev)], 1)
    start = torch.zeros((S, N + 1), dtype=torch.int64, device=dev)
    start[:, :N] = (pos % TILE == 0) & (pos < blen[:, None])
    # reachable from a tile's first byte in < 2^r steps, r = 1 .. 11
    for _ in range(int(math.log2(TILE))):
        start = start.scatter_reduce(1, succ, start, "amax")
        succ = succ.gather(1, succ)
    start = start[:, :N] > 0
    return start, torch.where(start, taken, 0)


def tokens(block: torch.Tensor, blen: torch.Tensor):
    """(start, length, dist) [S, N]: the token starts of the parse, each
    start's match length (0 for a literal) and distance."""
    length, dist = search(block, blen)
    start, taken = parse(length, blen)
    return start, taken, torch.where(taken > 0, dist, 0)


def _codes(base, value: torch.Tensor) -> torch.Tensor:
    b = torch.tensor(base, dtype=torch.int64, device=value.device)
    return torch.searchsorted(b, value, right=True) - 1


def _entropy_bits(counts: torch.Tensor) -> torch.Tensor:
    """Sum over symbols of c * log2(total / c), per row, float64."""
    c = counts.to(torch.float64)
    total = c.sum(1, keepdim=True)
    return (c * torch.log2(torch.where(c > 0, total / c.clamp(min=1),
                                       1.0))).sum(1)


def block_bits(block: torch.Tensor, blen: torch.Tensor) -> torch.Tensor:
    """float64 [S]: the entropy size of each block's level-3 parse."""
    start, taken, dist = tokens(block, blen)
    S = block.shape[0]
    dev = block.device
    match = start & (taken > 0)
    lit = start & ~match
    lcode = _codes(LEN_BASE, taken.clamp(min=MIN_MATCH))
    dcode = _codes(DIST_BASE, dist.clamp(min=1))
    sym = torch.where(match, 257 + lcode, block.to(torch.int64))
    lit_hist = torch.zeros((S, 286), dtype=torch.int64, device=dev)
    lit_hist.scatter_add_(1, sym, (lit | match).to(torch.int64))
    lit_hist[:, EOB] += 1
    dist_hist = torch.zeros((S, 30), dtype=torch.int64, device=dev)
    dist_hist.scatter_add_(1, dcode, match.to(torch.int64))
    len_eb = torch.tensor(LEN_EXTRA, dtype=torch.int64, device=dev)[lcode]
    dist_eb = torch.tensor(DIST_EXTRA, dtype=torch.int64, device=dev)[dcode]
    extra = torch.where(match, len_eb + dist_eb, 0).sum(1)
    return (_entropy_bits(lit_hist) + _entropy_bits(dist_hist)
            + extra.to(torch.float64))
