"""Kernel K7: place variable-width packets at their bit offsets in each
block's words (csrc/pack.cu).

Replaces deflate_tpu/ops/pallas_pack.py (`_kernel`, wrapper
`pack_blocks`).  Contract (built by models/encoder.build_packets): per
block, `count` live packets, each with its bit offset `off` (>= 0 and
not decreasing over [0, count): an exclusive sum of widths) and payload
bits 0..31 in `lo`, 32..63 in `hi` (zero past the packet's width); lanes
past `count` are not read.  Packets never share a bit, so the words are
the OR — equally the sum — of every packet's shifted payload; words at
or past OUTW are dropped.  Plain version: one scatter-add of the three
shifted words of every packet on int64 rows (it does not need the
offsets in order).  `pack_blocks_tiles` is the torch form of the
kernel's design, which does.
"""
from __future__ import annotations

import functools

import torch

from deflate_tpu_torch import _build
from deflate_tpu_torch.ops import bitpack as BP
from deflate_tpu_torch.utils import metrics
from deflate_tpu_torch.utils.bits import I32, I64, M32, u32, wrap32

NPK = 33 * 1024           # packet lanes per block: 4 preamble + <= 654
                          # header entries + 32768 tokens + 1 EOB, rounded
OUTW = 9 * 1024           # output words per block (>= encoder WB = 8195)
TILE = 1024               # output words a CTA of K7 owns


def _check(counts, off, lo, hi):
    B = counts.shape[0]
    for x in (off, lo, hi):
        if tuple(x.shape) != (B, NPK):
            raise ValueError(f"packet lanes {tuple(x.shape)}, want "
                             f"{(B, NPK)}")


def _shifted(off, lo, hi):
    """A packet's payload at bit off & 31 of word off >> 5: (word int64,
    its three int64 words)."""
    off = off.to(I64)
    lo, hi = u32(lo), u32(hi)
    r = off & 31
    nr = 32 - torch.clamp(r, min=1)
    return off >> 5, [(lo << r) & M32,
                      torch.where(r == 0, hi, (lo >> nr) | ((hi << r) & M32)),
                      torch.where(r == 0, 0, hi >> nr)]


def packet_words(counts, off, lo, hi):
    """Each packet's payload as three shifted words and their word
    indices: (idx int64 [B, 3*NPK], vals int64 [B, 3*NPK]); lanes past
    `count` and words past OUTW get index OUTW."""
    _check(counts, off, lo, hi)
    live = torch.arange(NPK, device=off.device)[None, :] < counts[:, None]
    w, vals = _shifted(off, lo, hi)
    idx = [torch.where(live & (w + k < OUTW), w + k, OUTW) for k in range(3)]
    return torch.cat(idx, 1), torch.cat(vals, 1)


def pack_blocks_plain(counts, off, lo, hi):
    """int32 [B, OUTW] words: the packets' shifted words scatter-added
    into int64 rows (a word past OUTW is dropped)."""
    return BP.scatter_words(OUTW, *packet_words(counts, off, lo, hi))


def pack_blocks_tiles(counts, off, lo, hi):
    """Same contract as pack_blocks_plain, for offsets that do not
    decrease over [0, count), computed as csrc/pack.cu does.

    Each row is cut into tiles of TILE words.  A tile that starts past
    the row's last live word, (off[count-1] >> 5) + 2, is dead: zeros,
    and no packet is read.  A live tile [W0, W1) takes the packets
    [p0, p1) with p0 the lower bound of 32 (W0 - 2) and p1 that of 32 W1
    in the row's offsets (a packet spans at most three words, so one
    that starts before word W0 - 2 ends before W0), skips those whose
    payload is zero, and adds the shifted words that fall in the tile."""
    _check(counts, off, lo, hi)
    B = counts.shape[0]
    dev = off.device
    out = torch.zeros((B, OUTW), dtype=I64, device=dev)
    for b, n in enumerate(counts.to(I64).clamp(0, NPK).tolist()):
        if n == 0:
            continue
        o = off[b, :n].to(I64).contiguous()
        last = int(o[-1]) // 32 + 2
        for w0 in range(0, min(OUTW, last + 1), TILE):
            w1 = min(w0 + TILE, OUTW)
            p0, p1 = torch.searchsorted(
                o, torch.tensor([32 * (w0 - 2), 32 * w1], device=dev)).tolist()
            keep = (lo[b, p0:p1] != 0) | (hi[b, p0:p1] != 0)
            w, vals = _shifted(o[p0:p1][keep], lo[b, p0:p1][keep],
                               hi[b, p0:p1][keep])
            idx = torch.cat([w, w + 1, w + 2])
            v = torch.cat(vals)
            sel = (idx >= w0) & (idx < w1) & (v != 0)
            out[b].index_add_(0, idx[sel], v[sel])
    return wrap32(out)


@functools.lru_cache(maxsize=None)
def _entry():
    """The ctypes function of dt_pack_blocks, resolved once."""
    return _build.lib("pack").dt_pack_blocks


def pack_launch(counts, off, lo, hi, out) -> None:
    """dt_pack_blocks alone on checked operands (counts int32 [B];
    off, lo, hi int32 [B, NPK]; all contiguous on one card, off, lo and
    hi 16-byte aligned) into a preallocated out int32 [B, OUTW]."""
    _build.check(_entry()(counts.data_ptr(), off.data_ptr(), lo.data_ptr(),
                          hi.data_ptr(), out.data_ptr(), counts.shape[0],
                          NPK, OUTW, _build.stream_ptr(out.device)),
                 "dt_pack_blocks")


def pack_blocks_kernel(counts, off, lo, hi):
    """K7 on the card: same contract as pack_blocks_tiles."""
    if not (counts.dtype == off.dtype == lo.dtype == hi.dtype == I32
            and counts.is_contiguous() and off.is_contiguous()
            and lo.is_contiguous() and hi.is_contiguous()):
        counts, off, lo, hi = (x.to(I32).contiguous()
                               for x in (counts, off, lo, hi))
    if (off.data_ptr() | lo.data_ptr() | hi.data_ptr()) & 15:
        # a view that starts off a 16-byte line: the kernel loads int4
        off, lo, hi = (x.clone() if x.data_ptr() & 15 else x
                       for x in (off, lo, hi))
    _build.require_cuda(counts, off, lo, hi)
    _check(counts, off, lo, hi)
    out = off.new_empty((counts.shape[0], OUTW))
    if counts.shape[0]:
        pack_launch(counts, off, lo, hi, out)
        metrics.count("kernel.K7")
    return out


def pack_blocks(counts, off, lo, hi):
    """Pack B blocks' packet lists into per-block words.

    counts int32 [B]; off/lo/hi int32 [B, NPK].  Returns int32 [B, OUTW]
    (block-local bit offsets, word 0 = bit 0).  CUDA tensors run K7; CPU
    tensors the plain version."""
    fn = pack_blocks_kernel if off.is_cuda else pack_blocks_plain
    return fn(counts, off, lo, hi)
