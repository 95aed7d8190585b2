"""Bitstream assembly: concatenate variable-width bit fields, LSB-first.

Port of deflate_tpu/ops/bitmerge.py.  The reference builds a binary merge
tree of funnel shifts and log-step word rolls because scatters were slow
on the TPU; here every field is placed directly at its prefix-sum bit
offset with one integer ``scatter_add`` (fields occupy disjoint bits, so
the sum is their OR and the result is exact in any order).  Outputs, word
capacities and truncation are the reference's.
"""
from __future__ import annotations

import torch

from deflate_tpu_torch.utils.bits import I32, I64, M32, u32, wrap32


def _cap_words(density: int, slack: int, m: int, cap_bits: int) -> int:
    """Word capacity of a segment of m leaves."""
    return -(-min(density * m + slack, cap_bits) // 32)


def _place(lo64: torch.Tensor, hi64, off: torch.Tensor, W: int):
    """Sum of fields (lo64 | hi64 << 32) << off into int64 [rows, W]
    (32-bit words held in int64); bits past W words are dropped."""
    rows = lo64.shape[0]
    q = off >> 5
    r = off & 31
    a = lo64 << r
    parts = [a & M32, a >> 32]
    if hi64 is not None:
        b = hi64 << r
        parts[1] = parts[1] | (b & M32)
        parts.append(b >> 32)
    out = torch.zeros((rows, W + len(parts)), dtype=I64, device=lo64.device)
    for j, v in enumerate(parts):
        idx = torch.clamp(q + j, max=W + len(parts) - 1)
        out.scatter_add_(1, idx, torch.where(q + j < W, v, 0))
    return out[:, :W]


def merge_bitstream(lo, hi, sh, *, leaf_bits: int, density: int,
                    slack: int, cap_bits: int):
    """Concatenate, per batch row, S variable-width bit fields.

    lo: int32 [B, S] payload bits 0..31 (bits past sh zero); hi: int32
    [B, S] bits 32..63, or None when leaf_bits <= 32; sh: int32 [B, S]
    widths; S a power of two.  The density/slack bound gives the word
    capacity as in the reference.  Returns (words int32 [B, W_top],
    bits int32 [B]).
    """
    B, S = sh.shape
    assert S & (S - 1) == 0, S
    assert leaf_bits <= min(density + slack, 64)
    W = _cap_words(density, slack, S, cap_bits)
    sh64 = sh.to(I64)
    off = torch.cumsum(sh64, 1) - sh64
    words = _place(u32(lo), u32(hi) if leaf_bits > 32 else None, off, W)
    return wrap32(words), sh64.sum(1).to(I32)


def merge_words(words, bits, cap_words: int):
    """Concatenate B word-array segments at bit granularity.

    words: int32 [B, W0], bits beyond bits[b] zero; bits: int32 [B].
    Returns (stream int32 [cap_words], total_bits int32)."""
    Bn, W0 = words.shape
    b64 = bits.to(I64)
    seg_off = torch.cumsum(b64, 0) - b64
    off = (seg_off[:, None] + 32 * torch.arange(W0, dtype=I64,
                                               device=words.device))
    out = _place(u32(words).reshape(1, -1), None, off.reshape(1, -1),
                 cap_words)
    return wrap32(out[0]), b64.sum().to(I32)


def place_at(words, seg_words, seg_off):
    """OR segments seg_words int32 [B, Ws] into words int32 [B, W] at
    per-row bit offsets seg_off [B]; bits past W words are dropped."""
    Ws = seg_words.shape[1]
    W = words.shape[1]
    off = (seg_off.to(I64)[:, None]
           + 32 * torch.arange(Ws, dtype=I64, device=words.device))
    placed = _place(u32(seg_words), None, off, W)
    return wrap32(u32(words) | placed)
