"""Kernel K7: place variable-width packets at their bit offsets in each
block's words (csrc/pack.cu).

Replaces deflate_tpu/ops/pallas_pack.py (`_kernel`, wrapper
`pack_blocks`).  Contract (built by models/encoder.build_packets): per
block, `count` live packets, each with its bit offset `off` (monotone)
and payload bits 0..31 in `lo`, 32..47 in `hi` (zero past the packet's
width); lanes past `count` are not read.  Packets never share a bit, so
the words are the OR — equally the sum — of every packet's shifted
payload.  Plain version: one scatter-add of the three shifted words of
every packet on int64 rows.
"""
from __future__ import annotations

import torch

from deflate_tpu_torch import _build
from deflate_tpu_torch.ops import bitpack as BP
from deflate_tpu_torch.utils.bits import I32, I64, M32, u32

NPK = 33 * 1024           # packet lanes per block: 4 preamble + <= 654
                          # header entries + 32768 tokens + 1 EOB, rounded
OUTW = 9 * 1024           # output words per block (>= encoder WB = 8195)
launches = 0


def _check(counts, off, lo, hi):
    B = counts.shape[0]
    for x in (off, lo, hi):
        if tuple(x.shape) != (B, NPK):
            raise ValueError(f"packet lanes {tuple(x.shape)}, want "
                             f"{(B, NPK)}")


def packet_words(counts, off, lo, hi):
    """Each packet's payload as three shifted words and their word
    indices: (idx int64 [B, 3*NPK], vals int64 [B, 3*NPK]); lanes past
    `count` and words past OUTW get index OUTW."""
    _check(counts, off, lo, hi)
    live = torch.arange(NPK, device=off.device)[None, :] < counts[:, None]
    off = off.to(I64)
    lo, hi = u32(lo), u32(hi)
    w = off >> 5
    r = off & 31
    nr = 32 - torch.clamp(r, min=1)
    vals = [(lo << r) & M32,
            torch.where(r == 0, hi, (lo >> nr) | ((hi << r) & M32)),
            torch.where(r == 0, 0, hi >> nr)]
    idx = [torch.where(live & (w + k < OUTW), w + k, OUTW) for k in range(3)]
    return torch.cat(idx, 1), torch.cat(vals, 1)


def pack_blocks_plain(counts, off, lo, hi):
    """int32 [B, OUTW] words: the packets' shifted words scatter-added
    into int64 rows (a word past OUTW is dropped)."""
    return BP.scatter_words(OUTW, *packet_words(counts, off, lo, hi))


def pack_blocks_kernel(counts, off, lo, hi):
    """K7 on the card: same contract as pack_blocks_plain."""
    global launches
    counts, off, lo, hi = (x.to(I32).contiguous()
                           for x in (counts, off, lo, hi))
    dev = _build.require_cuda(counts, off, lo, hi)
    _check(counts, off, lo, hi)
    B = counts.shape[0]
    out = torch.empty((B, OUTW), dtype=I32, device=dev)
    if B:
        err = _build.lib("pack").dt_pack_blocks(
            counts.data_ptr(), off.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            out.data_ptr(), B, NPK, OUTW, _build.stream_ptr(dev))
        _build.check(err, "dt_pack_blocks")
        launches += 1
    return out


def pack_blocks(counts, off, lo, hi):
    """Pack B blocks' packet lists into per-block words.

    counts int32 [B]; off/lo/hi int32 [B, NPK].  Returns int32 [B, OUTW]
    (block-local bit offsets, word 0 = bit 0).  CUDA tensors run K7; CPU
    tensors the plain version."""
    fn = pack_blocks_kernel if off.is_cuda else pack_blocks_plain
    return fn(counts, off, lo, hi)
