"""Kernels K4 and K5: LZ77 match fill of the wavefront decoder
(csrc/wave_fill.cu, csrc/wave_fill_hist.cu).

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
dist <= 0 and drop bytes past the block's 32 KiB.  The kernel resolves a
row's copies at once by pointer jumping, which equals the ordered copy
when the row's records do not overlap and come in order of opos, as a
decoder's do; fill_matches_jump is that design in torch, and K6's fill
phase runs the same device code (csrc/fill_block.cuh).

K5 (fill_matches_hist, replacing `_kernel_seq`, wrapper
`fill_matches_hist`) fills the virtual blocks of a foreign-stream plan
in stream order: records arrive RAW, interleaved (opos | len3<<16, dist)
as models/wave_decoder._wave_group stacks them, and a record may reach
up to 32 KiB back into the output of any earlier row.  The kernel
resolves the whole plan at once by pointer jumping over its bytes;
fill_matches_hist_jump is that design in torch.
"""
from __future__ import annotations

import torch

from deflate_tpu_torch import _build
from deflate_tpu_torch.ops.wave import ND, NM
from deflate_tpu_torch.utils import metrics
from deflate_tpu_torch.utils.bits import I32, srl

OW = ND // 4                 # output words per block
HIST_MAX_ROUNDS = 64         # K5's jump-round flags (csrc/wave_fill_hist.cu)


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


def fill_matches_jump(litwords, recs, nmatch):
    """K4's design in torch (csrc/wave_fill.cu, csrc/fill_block.cuh): the
    same result as fill_matches_plain for rows whose records do not overlap
    and come in order of opos, as every decoder plan's do.  Each byte of a
    row points at the byte it copies: itself for a literal byte, else
    src + k % dist for byte k of a record.  Sources precede their targets,
    so every chain ends at a literal byte; pointers jump (ptr = ptr[ptr])
    until nothing changes, and each output byte is the literal byte at
    its chain's end."""
    B = litwords.shape[0]
    dev = litwords.device
    I64 = torch.int64
    live = (torch.arange(NM, device=dev)[None, :]
            < nmatch.to(I64).clamp(0, NM)[:, None])
    r = recs.to(I64).reshape(B, NM, 2)
    row = torch.arange(B, device=dev)[:, None].expand(B, NM)[live]
    r0, src = r[..., 0][live], r[..., 1][live]
    p = r0 & 0x7FFF
    fld = (r0 >> 16) & 0x7FFF
    rem = torch.where((r0 >> 15) & 1 > 0, 3 + (fld & 1), fld + 3)
    d = p - src
    n = torch.minimum(rem, ND - p)
    ok = (d > 0) & (src >= 0)
    base, p, n, src, d = row[ok] * ND, p[ok], n[ok], src[ok], d[ok]
    rec = torch.repeat_interleave(torch.arange(len(n), device=dev), n)
    k = torch.arange(len(rec), device=dev) - (torch.cumsum(n, 0) - n)[rec]
    ptr = torch.arange(B * ND, device=dev)
    ptr[base[rec] + p[rec] + k] = base[rec] + src[rec] + k % d[rec]
    while True:
        nxt = ptr[ptr]
        if torch.equal(nxt, ptr):
            break
        ptr = nxt
    lit = litwords.contiguous().view(torch.uint8).reshape(-1)
    return lit[ptr].view(I32).reshape(B, OW)


def fill_matches_kernel(litwords, recs, nmatch):
    """K4 on the card: the result of fill_matches_plain for every row
    whose records do not overlap and come in order of opos (the contract
    of csrc/fill_block.cuh, which every decoder plan meets)."""
    litwords = litwords.to(I32).contiguous()
    recs = recs.to(I32).contiguous()
    nmatch = nmatch.to(I32).contiguous()
    dev = _build.require_cuda(litwords, recs, nmatch)
    B = litwords.shape[0]
    if litwords.shape != (B, OW) or recs.shape != (B, 2 * NM) \
            or nmatch.shape != (B,):
        raise ValueError("fill operands must be litwords [B, 8192], "
                         "pack_fill_recs records [B, 2*NM], nmatch [B]")
    if litwords.data_ptr() % 16 or recs.data_ptr() % 8:
        litwords, recs = litwords.clone(), recs.clone()   # int4, int2 loads
    out = torch.empty_like(litwords)
    if B:
        err = _build.lib("wave_fill").dt_fill_matches(
            litwords.data_ptr(), recs.data_ptr(), nmatch.data_ptr(),
            out.data_ptr(), B, _build.stream_ptr(dev))
        _build.check(err, "dt_fill_matches")
        metrics.count("kernel.K4")
    return out


def fill_matches(litwords, recs, nmatch):
    """litwords int32 [B, OW] (literals placed), recs int32 [B, 2*NM] in
    the pack_fill_recs layout, nmatch int32 [B].  Returns int32 [B, OW].
    CUDA tensors run K4; CPU tensors the plain version."""
    fn = fill_matches_kernel if litwords.is_cuda else fill_matches_plain
    return fn(litwords, recs, nmatch)


def fill_matches_hist_plain(litwords, recs, nmatch, sizes):
    """Per-record sequential copy over rows in stream order with a 32 KiB
    history: the window is [last 32 KiB of output | current row], zeros
    before the first output byte, and slides by sizes[b] bytes after row
    b.  A record at row byte opos copies len3 + 3 bytes from dist bytes
    back (clamped to the window's first byte, as the reference clamps);
    bytes past the row's 32 KiB are dropped.  Returns int32 [B, OW]; row
    b is valid up to sizes[b] bytes."""
    B = litwords.shape[0]
    dev = litwords.device
    rows = litwords.contiguous().view(torch.uint8).reshape(B, ND)
    win = torch.zeros(2 * ND, dtype=torch.uint8, device=dev)
    out = torch.empty((B, ND), dtype=torch.uint8, device=dev)
    for b, (nm, size) in enumerate(zip(nmatch.tolist(), sizes.tolist())):
        win[ND:] = rows[b]
        nm = min(max(nm, 0), NM)
        rb = recs[b, :2 * nm].tolist()
        for m in range(nm):
            r0, dist = rb[2 * m], rb[2 * m + 1]
            opos = r0 & 0xFFFF
            p = ND + opos
            src = max(p - dist, 0)
            n = min(((r0 >> 16) & 0xFFFF) + 3, ND - opos)
            if p - src <= 0 or n <= 0:
                continue
            k = torch.arange(n, device=dev)
            win[p:p + n] = win[src + k % (p - src)]
        out[b] = win[ND:]
        s = min(max(size, 0), ND)
        win[:ND] = win[s:s + ND].clone()
    return out.view(I32).reshape(B, OW)


def fill_matches_hist_jump(litwords, recs, nmatch, sizes):
    """K5's design in torch (csrc/wave_fill_hist.cu): the same result as
    fill_matches_hist_plain for rows whose records do not overlap.  Every
    byte of the padded plan [B, ND], plus a ZERO sentinel at B * ND that
    reads 0, points at the byte it copies: itself for a literal byte,
    else the record's source — its own row at or past the window's row
    start, else the earlier row holding that stream byte, or ZERO before
    the stream.  Pointers jump (ptr[x] = ptr[ptr[x]]; a pointer known to
    end its chain is stored complemented) until nothing changes; each
    output byte is the literal byte at its chain's end."""
    B = litwords.shape[0]
    dev = litwords.device
    N = B * ND
    I64 = torch.int64
    size = sizes.to(I64).clamp(0, ND)
    starts = torch.cumsum(size, 0) - size
    live = (torch.arange(NM, device=dev)[None, :]
            < nmatch.to(I64).clamp(0, NM)[:, None])
    r = recs.to(I64).reshape(B, NM, 2)
    row = torch.arange(B, device=dev)[:, None].expand(B, NM)[live]
    r0, dist = r[..., 0][live], r[..., 1][live]
    opos = r0 & 0xFFFF
    n = torch.minimum(((r0 >> 16) & 0xFFFF) + 3, ND - opos)
    p = ND + opos
    src = (p - dist).clamp(min=0)
    d = p - src
    ok = (d > 0) & (n > 0)
    row, opos, n, src, d = row[ok], opos[ok], n[ok], src[ok], d[ok]
    rec = torch.repeat_interleave(torch.arange(len(n), device=dev), n)
    k = torch.arange(len(rec), device=dev) - (torch.cumsum(n, 0) - n)[rec]
    w = src[rec] + k % d[rec]                    # window byte
    brow = row[rec]
    t = starts[brow] - ND + w                    # stream byte, if w < ND
    hrow = (torch.searchsorted(starts, t, right=True) - 1).clamp(min=0)
    source = torch.where(w >= ND, brow * ND + w - ND,
                         torch.where(t < 0, N, hrow * ND + t - starts[hrow]))
    ptr = torch.arange(N + 1, device=dev)
    ptr[brow * ND + opos[rec] + k] = source
    x = torch.arange(N + 1, device=dev)
    while True:
        q = ptr[ptr.clamp(min=0)]
        nxt = torch.where((ptr < 0) | (ptr == x), ptr,
                          torch.where(q < 0, q, torch.where(q == ptr, ~ptr, q)))
        if torch.equal(nxt, ptr):
            break
        ptr = nxt
    end = torch.where(ptr < 0, ~ptr, ptr)[:N]
    lit = torch.cat([litwords.contiguous().view(torch.uint8).reshape(-1),
                     torch.zeros(1, dtype=torch.uint8, device=dev)])
    return lit[end].view(I32).reshape(B, OW)


def fill_matches_hist_kernel(litwords, recs, nmatch, sizes):
    """K5 on the card: same contract as fill_matches_hist_plain."""
    litwords = litwords.to(I32).contiguous()
    recs = recs.to(I32).contiguous()
    nmatch = nmatch.to(I32).contiguous()
    sizes = sizes.to(I32).contiguous()
    dev = _build.require_cuda(litwords, recs, nmatch, sizes)
    B = litwords.shape[0]
    if litwords.shape != (B, OW) or recs.shape != (B, 2 * NM) \
            or nmatch.shape != (B,) or sizes.shape != (B,):
        raise ValueError("hist fill operands must be litwords [B, 8192], "
                         "raw records [B, 2*NM], nmatch [B], sizes [B]")
    if B * ND >= 2**31 - 1:
        raise ValueError(f"hist fill of {B} rows: byte pointers exceed "
                         "int32")
    out = torch.empty_like(litwords)
    if B:
        ptr = torch.empty(B * ND + 1, dtype=I32, device=dev)
        starts = torch.empty(B + 1, dtype=I32, device=dev)
        flags = torch.empty(HIST_MAX_ROUNDS, dtype=I32, device=dev)
        err = _build.lib("wave_fill_hist").dt_fill_matches_hist(
            litwords.data_ptr(), recs.data_ptr(), nmatch.data_ptr(),
            sizes.data_ptr(), out.data_ptr(), ptr.data_ptr(),
            starts.data_ptr(), flags.data_ptr(), B, _build.stream_ptr(dev))
        _build.check(err, "dt_fill_matches_hist")
        metrics.count("kernel.K5")
    return out


def fill_matches_hist(litwords, recs, nmatch, sizes):
    """litwords int32 [B, OW] in stream order, recs int32 [B, 2*NM] raw
    interleaved (opos | len3<<16, dist), nmatch [B], sizes [B] output
    bytes per row.  Returns int32 [B, OW].  CUDA tensors run K5; CPU
    tensors the plain version."""
    fn = (fill_matches_hist_kernel if litwords.is_cuda
          else fill_matches_hist_plain)
    return fn(litwords, recs, nmatch, sizes)
