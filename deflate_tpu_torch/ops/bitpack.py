"""Parallel bit-stream assembly and inspection.

Port of deflate_tpu/ops/bitpack.py.  Per-entry bit lengths -> exclusive
prefix sum -> absolute bit offsets; each entry lands in at most two
32-bit words by a scatter-add (bits are disjoint, so add equals or), and
stream concatenation is the same trick one level up.  Words are int32
tensors holding the reference's uint32 patterns; the arithmetic runs on
int64 lanes, and an out-of-range word index is dropped as the
reference's ``mode="drop"`` does (it lands in a spare column that is cut
off).
"""
from __future__ import annotations

import numpy as np
import torch

from deflate_tpu_torch.utils.bits import I32, I64, M32, u32, wrap32


def scatter_words(num_words: int, idx: torch.Tensor, vals: torch.Tensor):
    """Sum of int64 vals [..., m] into word idx (>= num_words dropped),
    mod 2^32, as int32 [..., num_words]."""
    idx = torch.where(idx < num_words, idx, num_words).to(I64)
    out = torch.zeros(idx.shape[:-1] + (num_words + 1,), dtype=I64,
                      device=idx.device)
    return wrap32(out.scatter_add_(-1, idx, vals)[..., :num_words])


def pack_bits(values: torch.Tensor, lengths: torch.Tensor, num_words: int):
    """Pack LSB-first bit fields into 32-bit words.

    values [..., N] (masked to their lengths), lengths [..., N] (0..16, 0
    allowed).  Returns (words int32 [..., num_words], total_bits int32
    [...])."""
    lengths = lengths.to(I64)
    mask = torch.where(lengths > 0, (1 << lengths) - 1, 0)
    vals = values.to(I64) & mask & M32
    offs = torch.cumsum(lengths, -1) - lengths
    total = lengths.sum(-1)
    widx = offs >> 5
    shift = offs & 31
    lo = (vals << shift) & M32
    hi = torch.where(shift == 0, 0, vals >> (32 - shift))
    words = scatter_words(num_words, torch.cat([widx, widx + 1], -1),
                           torch.cat([lo, hi], -1))
    return words, total.to(I32)


def concat_bitstreams(block_words: torch.Tensor, block_bits: torch.Tensor,
                      num_words: int):
    """Concatenate B bit streams at bit granularity.

    block_words int32 [B, W] (bits past block_bits[b] zero), block_bits
    int32 [B].  Returns (words int32 [num_words], total_bits int32)."""
    B, W = block_words.shape
    bits = block_bits.to(I64)
    offs = torch.cumsum(bits, 0) - bits
    base = offs >> 5
    s = (offs & 31)[:, None]
    w = u32(block_words)
    prev = torch.cat([torch.zeros_like(w[:, :1]), w[:, :-1]], 1)
    shifted = ((w << s) & M32) | torch.where(s == 0, 0, prev >> (32 - s))
    tail = torch.where(s[:, 0] == 0, 0, w[:, -1] >> (32 - s[:, 0]))
    tgt = base[:, None] + torch.arange(W, dtype=I64,
                                       device=block_words.device)[None, :]
    words = scatter_words(num_words,
                           torch.cat([tgt.reshape(-1), base + W]),
                           torch.cat([shifted.reshape(-1), tail]))
    return words, bits.sum().to(I32)


def peek_bits(words: torch.Tensor, bitpos: torch.Tensor, n: int):
    """Read `n` (<= 32) bits LSB-first at bit offsets `bitpos` (any shape)
    of words int32 [nw]; bits past the end read as 0.  Returns int32 bit
    patterns of bitpos' shape."""
    bitpos = bitpos.to(I64)
    nw = words.shape[0]
    w = bitpos >> 5
    s = bitpos & 31
    wu = u32(words)

    def at(i):
        return torch.where(i < nw, wu[torch.clamp(i, max=nw - 1)], 0)

    out = (at(w) >> s) | torch.where(s == 0, 0, (at(w + 1) << (32 - s)) & M32)
    if n < 32:
        out = out & ((1 << n) - 1)
    return wrap32(out)


def words_to_bytes(words, total_bits) -> bytes:
    """Host helper: 32-bit words -> bytes, trimmed to ceil(bits / 8)."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    nbytes = (int(total_bits) + 7) // 8
    raw = np.asarray(words).astype(np.uint32).view(np.uint8)
    return raw[:nbytes].tobytes()


def bytes_to_words(data: bytes):
    """Host helper: bytes -> (uint32 words numpy, nbits)."""
    pad = (-len(data)) % 4
    buf = np.frombuffer(data + b"\x00" * pad, dtype=np.uint8)
    return buf.view(np.uint32).copy(), len(data) * 8
