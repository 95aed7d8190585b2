"""Speculative per-bit-offset token decode of one DEFLATE block body.

Port of deflate_tpu/ops/inflate_scan.py (plain XLA there, no Pallas
kernel; plain torch here).  A block body is decoded at every bit offset
at once, then the one true token chain is recovered by pointer doubling:

  phase 0: per-tree 2^15-entry LUT, so phase 1 decodes a symbol with one
           gather (build_lut)
  phase 1: at every bit offset, a full token (litlen symbol + extra +
           distance symbol + extra) -> (nbits, out_adv, payload)
           (token_scan)
  phase 2: jump[p] = p + nbits; the true chain is the orbit of offset 0,
           marked by log2(span) scatter/gather doubling rounds; EOB
           absorbs, invalid offsets fall off the end (find_chain)
  phase 3: output offsets by a prefix sum over the chain, literals
           scattered, back-references resolved by pointer doubling over
           the output (emit_block_output).

Every function runs on the device of its operands; the words are int32
tensors holding the stream's uint32 patterns.
"""
from __future__ import annotations

import torch

from deflate_tpu_torch.ops import bitpack as BP
from deflate_tpu_torch.ops import huffman as H
from deflate_tpu_torch.utils import tables as T
from deflate_tpu_torch.utils.bits import I32, I64

# compressed bits of one block body scanned in one shot: this package's
# encoder never emits a Huffman block larger than the stored alternative
# (3+7+32+8*32768 bits); a foreign block past it is flagged and the
# caller escalates or falls back
SPAN = (1 << 18) + 64
LUT_BITS = 15
LUT_SIZE = 1 << LUT_BITS


def _table(values, dev) -> torch.Tensor:
    return torch.as_tensor(values, dtype=I32, device=dev)


def scatter_max(base: torch.Tensor, idx: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """base with base[idx[j]] = max(base[idx[j]], vals[j]) (1-D).  An
    index outside [0, len(base)) is dropped, never clamped (XLA's
    ``.at[idx].max(vals, mode="drop")``)."""
    n = base.shape[0]
    idx = torch.where((idx >= 0) & (idx < n), idx, n).to(I64)
    out = torch.cat([base, base.new_zeros(1)])
    return out.scatter_reduce_(0, idx, vals.to(base.dtype), "amax",
                               include_self=True)[:n]


def build_lut(lengths: torch.Tensor) -> torch.Tensor:
    """Decode LUT over all 15-bit LSB-first windows: int32 [2^15] of
    (sym << 5) | code_len, 0 for an invalid window."""
    tbl = H.decode_tables(lengths)
    windows = torch.arange(LUT_SIZE, dtype=I32, device=lengths.device)
    sym, ln = H.decode_one(windows, tbl)
    return torch.where(ln > 0, (sym << 5) | ln, 0).to(I32)


def token_scan(words: torch.Tensor, lit_lut: torch.Tensor,
               dist_lut: torch.Tensor, start, span: int = SPAN):
    """A speculative token at every bit offset start + [0, span).

    Returns a dict of [span] tensors: nbits, out_adv, lit, length, dist
    (int32) and is_lit, is_match, is_eob, invalid (bool).  The
    reference's ``max_dist`` argument has no caller and is left out."""
    dev = words.device
    p = start + torch.arange(span, dtype=I32, device=dev)
    e = lit_lut[BP.peek_bits(words, p, LUT_BITS).to(I64)]
    sym = e >> 5
    ll = e & 31
    is_eob = sym == 256
    is_lit = sym < 256
    is_len = (sym > 256) & (sym < 286)

    lc = torch.clamp(sym - 257, 0, 28).to(I64)
    leb = _table(T.LENGTH_EXTRA, dev)[lc]
    lext = BP.peek_bits(words, p + ll, 5) & ((1 << leb) - 1)
    length = _table(T.LENGTH_BASE, dev)[lc] + lext

    q = p + ll + leb
    de = dist_lut[BP.peek_bits(words, q, LUT_BITS).to(I64)]
    dsym = de >> 5
    dl = de & 31
    dvalid = (dl > 0) & (dsym < 30)
    dc = torch.clamp(dsym, 0, 29).to(I64)
    deb = _table(T.DIST_EXTRA, dev)[dc]
    dext = BP.peek_bits(words, q + dl, 13) & ((1 << deb) - 1)
    dist = _table(T.DIST_BASE, dev)[dc] + dext

    nbits = torch.where(is_len, ll + leb + dl + deb, ll)
    invalid = (ll == 0) | ((sym >= 286) & ~is_eob) | (is_len & ~dvalid)
    out_adv = torch.where(is_lit, 1, torch.where(is_len, length, 0))
    return {"nbits": nbits.to(I32), "out_adv": out_adv.to(I32),
            "is_lit": is_lit, "is_match": is_len, "is_eob": is_eob,
            "invalid": invalid, "lit": torch.where(is_lit, sym, 0).to(I32),
            "length": length.to(I32), "dist": dist.to(I32)}


def mark_orbit(nxt: torch.Tensor, rounds: int) -> torch.Tensor:
    """Mark the orbit of slot 0 under nxt int32 [n] (values in [0, n],
    n the sink) by `rounds` pointer-doubling rounds; returns the int32
    marks of the n slots and the sink."""
    n = nxt.shape[0]
    g = torch.cat([nxt, nxt.new_full((1,), n)]).to(I64)
    mark = torch.zeros(n + 1, dtype=I32, device=nxt.device)
    mark[0] = 1
    for _ in range(rounds):
        tgt = torch.where(mark > 0, g, n)
        mark = mark.scatter_reduce(0, tgt, mark, "amax", include_self=True)
        g = g[g]
    return mark


def find_chain(tok, span: int = SPAN):
    """Phase 2: mark the true token chain from local offset 0.

    Returns (reached bool [span] — true tokens, EOB excluded;
             eob_local int32 — offset of the EOB token, or span;
             error bool — the chain hit an invalid token)."""
    i = torch.arange(span, dtype=I32, device=tok["nbits"].device)
    nxt = i + torch.clamp(tok["nbits"], min=1)
    nxt = torch.where(tok["is_eob"], i, nxt)                # EOB absorbs
    nxt = torch.where(tok["invalid"], span, nxt)            # invalid escapes
    nxt = torch.clamp(nxt, max=span)
    mark = mark_orbit(nxt, max(1, (span - 1).bit_length()))[:span] > 0

    eob_local = torch.where(mark & tok["is_eob"], i, span).min()
    error = (mark & tok["invalid"] & ~tok["is_eob"]).any()
    reached = mark & ~tok["is_eob"] & ~tok["invalid"]
    return reached, eob_local, error


def emit_block_output(tok, reached, out_len: int):
    """Phase 3 for one block whose output fits in out_len bytes and whose
    back-references stay inside it (this package's encoder's Q5
    invariant).  Returns (out uint8 [out_len], produced int32)."""
    dev = reached.device
    adv = torch.where(reached, tok["out_adv"], 0)
    opos = (torch.cumsum(adv, 0) - adv).to(I32)
    produced = adv.sum().to(I32)

    idx = torch.clamp(opos, 0, out_len - 1)
    is_lit = reached & tok["is_lit"]
    is_m = reached & tok["is_match"]

    # per-output-byte token info by a scatter and a running max
    tstart = scatter_max(torch.full((out_len,), -1, dtype=I32, device=dev),
                         idx, torch.where(reached & (tok["out_adv"] > 0),
                                          opos, -1))
    tstart = torch.cummax(tstart, 0).values
    zero = torch.zeros(out_len, dtype=I32, device=dev)
    litv = scatter_max(zero, idx, torch.where(is_lit, tok["lit"], 0))
    dstv = scatter_max(zero, idx, torch.where(is_m, tok["dist"], 0))
    lit_flag = scatter_max(zero, idx, is_lit.to(I32))

    o = torch.arange(out_len, dtype=I32, device=dev)
    ts = torch.clamp(tstart, 0, out_len - 1).to(I64)
    known = lit_flag[ts] > 0                               # literal bytes
    val = litv[ts]
    src = torch.clamp(torch.where(known, o, o - dstv[ts]), 0,
                      out_len - 1).to(I64)
    for _ in range(16):
        ks = known[src]
        val = torch.where(~known & ks, val[src], val)
        known = known | ks
        src = torch.where(known, src, src[src])
    return val.to(torch.uint8), produced
