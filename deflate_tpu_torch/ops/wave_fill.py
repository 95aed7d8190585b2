"""Kernel K4: LZ77 match fill of the wavefront decoder (csrc/wave_fill.cu).

Replaces deflate_tpu/ops/wave_fill.py (`_kernel`, wrapper
`fill_matches`).  After stage F has placed every literal byte, each
block's match records copy bytes in record order, each from output
produced earlier.

Records arrive in the pack_fill_recs layout, interleaved [B, 2*NM]:
  r0 = opos(15) | tiny<<15 | field(15)<<16 | short<<31
       tiny (len<=4 & dist>=4): field bit 0 = (len == 4); else field =
       len-3
  r1 = max(opos - dist, 0), the source position
so a record copies len bytes to opos from src = r1 with dist =
opos - r1.  A byte-sequential copy equals the periodic extension
out[opos + k] = out[src + k % dist], whose sources all precede opos; the
plain version and the kernel both compute that, skip records with
dist <= 0 and drop bytes past the block's 32 KiB.
"""
from __future__ import annotations

import torch

from deflate_tpu_torch import _build
from deflate_tpu_torch.ops.wave import ND, NM
from deflate_tpu_torch.utils.bits import I32, srl

OW = ND // 4                 # output words per block
launches = 0


def pack_fill_recs(rec0, rec1):
    """rec0 [B, NM] = opos | len3<<16, rec1 [B, NM] = dist -> the packed
    interleaved layout [B, 2*NM] (module docstring)."""
    p = rec0 & 0xFFFF
    len3 = srl(rec0, 16)
    rem = len3 + 3
    dist = rec1
    tiny = (rem <= 4) & (dist >= 4)
    short = (rem <= 8) & (dist >= 8) & ~tiny
    fld = torch.where(tiny, (rem >= 4).to(I32), len3 & 0x7FFF)
    r0 = ((p & 0x7FFF) | (tiny.to(I32) << 15) | (fld << 16)
          | (short.to(I32) << 31))
    r1 = torch.clamp(p - dist, min=0)
    return torch.stack([r0, r1], 2).reshape(rec0.shape[0], -1)


def _unpack(r0: int, r1: int):
    p = r0 & 0x7FFF
    fld = (r0 >> 16) & 0x7FFF
    rem = 3 + (fld & 1) if (r0 >> 15) & 1 else fld + 3
    return p, rem, r1


def fill_matches_plain(litwords, recs, nmatch):
    """Per-record sequential copy; litwords int32 [B, OW]."""
    B = litwords.shape[0]
    dev = litwords.device
    out = litwords.contiguous().clone().view(torch.uint8).reshape(B, ND)
    for b, nm in enumerate(nmatch.tolist()):
        nm = min(max(nm, 0), NM)
        rb = recs[b, :2 * nm].tolist()
        ob = out[b]
        for m in range(nm):
            p, rem, src = _unpack(rb[2 * m], rb[2 * m + 1])
            dist = p - src
            n = min(rem, ND - p)
            if dist <= 0 or n <= 0:
                continue
            k = torch.arange(n, device=dev)
            ob[p:p + n] = ob[src + k % dist]
    return out.view(I32).reshape(B, OW)


def fill_matches_kernel(litwords, recs, nmatch):
    """K4 on the card: same contract as fill_matches_plain."""
    global launches
    litwords = litwords.to(I32).contiguous()
    recs = recs.to(I32).contiguous()
    nmatch = nmatch.to(I32).contiguous()
    dev = _build.require_cuda(litwords, recs, nmatch)
    B = litwords.shape[0]
    if litwords.shape != (B, OW) or recs.shape != (B, 2 * NM) \
            or nmatch.shape != (B,):
        raise ValueError("fill operands must be litwords [B, 8192], "
                         "pack_fill_recs records [B, 2*NM], nmatch [B]")
    out = torch.empty_like(litwords)
    if B:
        err = _build.lib("wave_fill").dt_fill_matches(
            litwords.data_ptr(), recs.data_ptr(), nmatch.data_ptr(),
            out.data_ptr(), B, _build.stream_ptr(dev))
        _build.check(err, "dt_fill_matches")
        launches += 1
    return out


def fill_matches(litwords, recs, nmatch):
    """litwords int32 [B, OW] (literals placed), recs int32 [B, 2*NM] in
    the pack_fill_recs layout, nmatch int32 [B].  Returns int32 [B, OW].
    CUDA tensors run K4; CPU tensors the plain version."""
    fn = fill_matches_kernel if litwords.is_cuda else fill_matches_plain
    return fn(litwords, recs, nmatch)
