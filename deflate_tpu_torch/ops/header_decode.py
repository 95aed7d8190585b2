"""Dynamic-Huffman header parse on the device (RFC 1951 §3.2.7).

Port of deflate_tpu/ops/header_decode.py (plain XLA there, plain torch
here).  The code-length (CL) symbol stream is serial, since each op's
width depends on its symbol; the same speculation as the body decode
(ops/inflate_scan.py) breaks that:

  1. a speculative CL op at every bit offset of the header span
  2. the true op chain by pointer doubling over the span (13 rounds)
  3. op values (op 16 repeats the last defining length) by a running
     max of (offset << 5 | value); emit positions by a prefix sum
  4. run starts scattered into the litlen+dist length array, filled
     forward by a running max of (run_start << 5 | value).
"""
from __future__ import annotations

import torch

from deflate_tpu_torch.ops import bitpack as BP
from deflate_tpu_torch.ops import huffman as H
from deflate_tpu_torch.ops.inflate_scan import mark_orbit, scatter_max
from deflate_tpu_torch.utils import tables as T
from deflate_tpu_torch.utils.bits import I32, I64

# worst-case dynamic header: 17 preamble + 19*3 CL lengths + 320 ops of
# (7-bit code + up to 7 extra bits); 4608 bits covers it with slack
HSPAN = 4608
NLTOT = 320                       # hlit <= 288 combined with hdist <= 32


def parse_dynamic_header(words: torch.Tensor, start):
    """Parse one dynamic block header from bit offset `start` (the HLIT
    field, 3 bits past the block header) of words int32 [W].

    Returns dict: litlen_lens int32 [288], dist_lens int32 [30],
    body_start int32 (bit offset of the first symbol) and error bool
    (bad lengths, oversubscribed CL code, run overflow, missing EOB
    code), all on the words' device."""
    dev = words.device
    start = torch.as_tensor(start, device=dev).to(I32)
    hlit = BP.peek_bits(words, start, 5) + 257
    hdist = BP.peek_bits(words, start + 5, 5) + 1
    hclen = BP.peek_bits(words, start + 10, 4) + 4

    # 3-bit CL code lengths, sent in the RFC's permutation order
    slot = torch.arange(19, dtype=I32, device=dev)
    raw = BP.peek_bits(words, start + 14 + 3 * slot, 3)
    raw = torch.where(slot < hclen, raw, 0)
    cl_lens = torch.zeros(19, dtype=I32, device=dev)
    cl_lens[torch.as_tensor(T.CL_ORDER, dtype=I64, device=dev)] = raw
    cl_tbl = H.decode_tables(cl_lens)
    # oversubscription: Kraft sum in units of 2^-7
    lens7 = torch.arange(1, T.MAX_CL_CODE_LEN + 1, dtype=I32, device=dev)
    kraft = (cl_tbl["count"][1:T.MAX_CL_CODE_LEN + 1]
             * (1 << (T.MAX_CL_CODE_LEN - lens7))).sum()
    cl_oversub = kraft > (1 << T.MAX_CL_CODE_LEN)

    codes_start = start + 14 + 3 * hclen

    # --- phase 1: speculative CL op at every offset -----------------------
    i = torch.arange(HSPAN, dtype=I32, device=dev)
    p = codes_start + i
    sym, ln = H.decode_one(BP.peek_bits(words, p, 7), cl_tbl)
    sym = torch.where(ln > 0, sym, 19)              # 19 = invalid marker
    eb = torch.where(sym == 16, 2, torch.where(
        sym == 17, 3, torch.where(sym == 18, 7, 0))).to(I32)
    ev = BP.peek_bits(words, p + ln, 7) & ((1 << eb) - 1)
    nbits = ln + eb
    cnt = torch.where(sym < 16, 1, torch.where(
        sym == 16, 3 + ev, torch.where(sym == 17, 3 + ev, 11 + ev)))
    invalid = sym >= 19
    cnt = torch.where(invalid, 0, cnt).to(I32)

    # --- phase 2: true op chain by pointer doubling -----------------------
    nxt = torch.where(invalid, HSPAN, i + torch.clamp(nbits, min=1))
    nxt = torch.clamp(nxt, max=HSPAN).to(I32)
    reached = mark_orbit(nxt, 13)[:HSPAN] > 0

    # --- phase 3: emit offsets and the stop point -------------------------
    target = hlit + hdist
    c = torch.where(reached, cnt, 0)
    cum = (torch.cumsum(c, 0) - c).to(I32)          # emitted before this op
    real = reached & (cum < target)
    run_over = (real & (cum + cnt > target)).any()
    chain_err = (real & invalid).any()
    first16 = (real & (sym == 16) & (cum == 0)).any()   # 16 with no prior

    # value per op: sym < 16 -> sym, 17/18 -> 0, 16 -> the latest defining
    # value at or before it
    defining = real & ~invalid & (sym != 16)
    dval = torch.where(sym < 16, sym, 0)
    lastdef = torch.cummax(torch.where(defining, (i << 5) | dval, -1),
                           0).values
    v = torch.where(sym == 16, torch.clamp(lastdef, min=0) & 31, dval)

    # --- phase 4: scatter run starts, fill forward ------------------------
    run_start = torch.where(real, cum, NLTOT)
    owner = scatter_max(torch.full((NLTOT,), -1, dtype=I32, device=dev),
                        run_start,
                        torch.where(real, (run_start << 5) | v, -1))
    owner = torch.cummax(owner, 0).values
    lens = torch.where(owner >= 0, owner & 31, 0)    # [NLTOT]

    j = torch.arange(T.NUM_LITLEN, dtype=I32, device=dev)
    litlen_lens = torch.where(j < hlit,
                              lens[torch.clamp(j, max=NLTOT - 1).to(I64)], 0)
    k = torch.arange(30, dtype=I32, device=dev)
    dist_lens = torch.where(
        k < hdist, lens[torch.clamp(hlit + k, 0, NLTOT - 1).to(I64)], 0)

    # header end: the first real op that completes the emission
    body_off = torch.where(real & (cum + cnt == target), i + nbits,
                           -1).max()
    body_start = codes_start + torch.clamp(body_off, min=0)

    error = (cl_oversub | run_over | chain_err | first16 | (body_off < 0)
             | (hlit > 286) | (hdist > 30) | (litlen_lens[256] == 0))
    return {"litlen_lens": litlen_lens.to(I32), "dist_lens": dist_lens.to(I32),
            "body_start": body_start.to(I32), "error": error}
