"""The DEFLATE encoder pipeline over a batch of 32 KiB blocks.

Port of deflate_tpu/models/encoder.py, levels 0-3.  Stages, each
batched over blocks:

  A. LZ77 tokens -> symbol histograms -> Huffman trees (kernel K1 on
     CUDA, ops/tree.py) + dynamic header fields -> analytic candidate
     sizes (fixed / dynamic / stored);
  B. exact block-type choice and bit offsets (stored blocks need the
     running stream phase for their byte-align padding);
  C. emission of the chosen encoding, by one of three backends that give
     identical words: "merge" (the default; direct bit placement,
     ops/bitmerge.py), "scatter" (packet fusion, then a pair-fused
     scatter, emit_block) or "kernel" (packet fusion, compaction on
     kernel K3, placement on kernel K7, ops/pack.py); stored payloads by
     a whole-block funnel shift;
  D. bit-exact concatenation of the blocks at their offsets.
"""
from __future__ import annotations

import torch

from deflate_tpu_torch.ops import bitmerge as BM
from deflate_tpu_torch.ops import bitpack as BP
from deflate_tpu_torch.ops import header as HDR
from deflate_tpu_torch.ops import huffman as H
from deflate_tpu_torch.ops import lz77 as LZ
from deflate_tpu_torch.ops import pack as PK
from deflate_tpu_torch.ops import wave_route as WR
from deflate_tpu_torch.ops.wave import HINT_NONE
from deflate_tpu_torch.utils import metrics
from deflate_tpu_torch.utils import tables as T
from deflate_tpu_torch.utils.bits import I32, I64, M32, exclusive, u32, wrap32

N = T.BLOCK_SIZE
NT = N + 1                      # token slots incl. end-of-block
# worst case block: stored = 3 hdr + 7 pad + 32 len/nlen + 8*32768 data bits
MAX_BLOCK_BITS = 3 + 7 + 32 + 8 * N
WB = MAX_BLOCK_BITS // 32 + 2   # per-block word capacity
W64CAP = 4224                   # hint chunks kept per block

CH_STORED, CH_FIXED, CH_DYN = 0, 1, 2

# level-2 match finder settings (the reference's DT_WIN_WORDS and
# DT_TOOFAR3 defaults)
L2_CANDS = 4
L2_WIN_WORDS = 8
L2_TOOFAR3 = 256
PARSE_TILE = 512
# level-3 settings: deep chains, 128-byte windows, tiered 8- and 16-byte
# grams, large parse tiles, the far-match cut chosen per block
L3_CANDS = 48
L3_WIN_WORDS = 32
L3_TIERS = (2, 4)
L3_PARSE_TILE = 2048


def _t(a, dev):
    return metrics.to_device(torch.as_tensor(a, dtype=I32), dev)


def _flog2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 x) for 1 <= x < 2^24 via the float32 exponent."""
    return (x.to(torch.float32).view(I32) >> 23) - 127


def _len_code(length):
    """Match length 3..258 -> length-code index 0..28."""
    m = length - 3
    e = torch.clamp(_flog2(torch.clamp(m, min=1)) - 2, min=0)
    c = torch.where(m < 8, m, 4 + 4 * e + ((m >> e) - 4))
    return torch.where(length >= T.MAX_MATCH, 28, c)


def _len_base(c):
    e = torch.clamp((c - 4) >> 2, min=0)
    base = torch.where(c < 8, c, (1 << (e + 2)) + ((c - 4 - 4 * e) << e))
    return torch.where(c == 28, 255, base) + 3


def _len_eb(c):
    return torch.where((c < 8) | (c >= 28), 0, (c - 4) >> 2)


def _dist_code(d):
    """Distance 1..32768 -> distance code 0..29."""
    m = d - 1
    e = _flog2(torch.clamp(m, min=1))
    return torch.where(m < 4, m,
                       2 * e + ((m >> torch.clamp(e - 1, min=0)) & 1))


def _dist_base(c):
    e = torch.clamp((c >> 1) - 1, min=0)
    return torch.where(c < 4, c + 1, (1 << (e + 1)) + ((c & 1) << e) + 1)


def _dist_eb(c):
    return torch.clamp((c >> 1) - 1, min=0)


def _toofar3_by_entropy(block, blen):
    """Level 3's far-match cut per block, int32 [B]: 4096 where the byte
    entropy of the block's blen bytes is below 3.5 bits (bitmap-like
    data), else 256.  Float32 throughout, as the reference computes it;
    the sum runs in another order, so a block within float rounding of
    3.5 could in principle take the other cut."""
    cnt = _count(block.to(I32), 256)
    cnt[:, 0] -= N - blen                          # the zero padding
    p = cnt.to(torch.float32) / torch.clamp(blen, min=1).to(
        torch.float32)[:, None]
    ent = -torch.where(cnt > 0, p * torch.log2(torch.clamp(p, min=1e-12)),
                       0.0).sum(1)
    return torch.where(ent < 3.5, 4096, 256).to(I32)


def tokenize_block(block, blen, level: int):
    """LZ77 parse of blocks uint8 [B, N] into position-indexed token
    arrays ([B, N] each, plus ntok [B])."""
    tile = PARSE_TILE
    if level >= 3:
        length, dist = LZ.find_matches(block, blen, L3_CANDS,
                                       win_words=L3_WIN_WORDS,
                                       tiers=L3_TIERS,
                                       toofar3=_toofar3_by_entropy(block,
                                                                   blen))
        tile = L3_PARSE_TILE
    elif level == 2:
        length, dist = LZ.find_matches(block, blen, L2_CANDS,
                                       win_words=L2_WIN_WORDS,
                                       toofar3=L2_TOOFAR3)
    else:
        length = torch.zeros(block.shape, dtype=I32, device=block.device)
        dist = torch.zeros_like(length)
    mark, length = LZ.greedy_parse(length, blen, tile=tile)
    is_match = mark & (length >= T.MIN_MATCH)
    lcode = _len_code(torch.clamp(length, min=T.MIN_MATCH))
    dcode = _dist_code(torch.clamp(dist, min=1))
    lit_sym = torch.where(is_match, 257 + lcode, block.to(I32))
    return {"mark": mark, "is_match": is_match, "lit_sym": lit_sym,
            "len": length, "dist": dist, "lcode": lcode, "dcode": dcode,
            "ntok": mark.sum(1).to(I32)}


def _count(vals: torch.Tensor, nbins: int) -> torch.Tensor:
    """Per-row counts of int32 vals [B, n] in [0, nbins)."""
    return torch.zeros((vals.shape[0], nbins), dtype=I32,
                       device=vals.device).scatter_add_(
        1, vals.to(I64), torch.ones_like(vals))


def _plan_pre(block, blen, level: int):
    """Stage A part 1: tokens, sorted symbol keys, histograms."""
    tk = tokenize_block(block, blen, level)
    pos = torch.arange(N, dtype=I32, device=block.device)[None, :]
    sym_eff = torch.where(tk["mark"], tk["lit_sym"], 286)
    skey_l = torch.sort((sym_eff << 15) | pos, dim=1).values
    hist_lit = _count(sym_eff, 288)
    hist_lit[:, 286:] = 0
    hist_lit[:, 256] += 1                           # end-of-block
    dc_eff = torch.where(tk["is_match"], tk["dcode"], 30)
    hist_dist = _count(dc_eff, 32)[:, :30].contiguous()
    m_i = tk["is_match"].to(I32)
    extra_total = ((_len_eb(tk["lcode"]) + _dist_eb(tk["dcode"])) * m_i
                   ).sum(1).to(I32)
    return {"tk": tk, "skey_l": skey_l, "hist_lit": hist_lit,
            "hist_dist": hist_dist, "extra_total": extra_total}


def _plan_post(pre, dyn_lit_lens, dyn_dist_lens, hv, hl, header_bits):
    """Stage A part 2: analytic candidate sizes."""
    dev = dyn_lit_lens.device
    hist_lit, hist_dist = pre["hist_lit"], pre["hist_dist"]
    extra_total = pre["extra_total"]
    fixed_bits = (3 + (hist_lit * _t(T.FIXED_LITLEN_LENGTHS, dev)).sum(1)
                  + (hist_dist * _t(T.FIXED_DIST_LENGTHS[:30], dev)).sum(1)
                  + extra_total)
    dyn_bits = (3 + header_bits + (hist_lit * dyn_lit_lens).sum(1)
                + (hist_dist * dyn_dist_lens).sum(1) + extra_total)
    return {"dyn_lit_lens": dyn_lit_lens, "dyn_dist_lens": dyn_dist_lens,
            "header_vals": hv, "header_lens": hl,
            "fixed_bits": fixed_bits.to(I32), "dyn_bits": dyn_bits.to(I32)}


def batch_plan(blocks, blens, level: int):
    """Stage A over a batch: tokens/histograms, batched tree builds
    (litlen, dist and the header's CL tree — kernel K1 on CUDA), header
    fields, candidate sizes.  Its span holds the lz77 spans."""
    with metrics.span("encode.trees"):
        pre = _plan_pre(blocks, blens, level)
        dyn_lit_lens = H.huffman_lengths_batch(pre["hist_lit"],
                                               T.MAX_CODE_LEN)
        dyn_dist_lens = H.huffman_lengths_batch(pre["hist_dist"],
                                                T.MAX_CODE_LEN)
        hpre = HDR.header_pre(dyn_lit_lens, dyn_dist_lens)
        cl_lens = H.huffman_lengths_batch(hpre["cl_hist"],
                                          T.MAX_CL_CODE_LEN)
        hv, hl, hb = HDR.header_post(hpre, cl_lens)
        return {**pre, **_plan_post(pre, dyn_lit_lens, dyn_dist_lens,
                                    hv, hl, hb)}


def block_plan(block, blen, level: int):
    """Stage A for one block uint8 [N] (a batch of one)."""
    plan = batch_plan(block[None], blen.reshape(1), level)
    return {k: ({kk: vv[0] for kk, vv in v.items()} if k == "tk"
                else v[0]) for k, v in plan.items()}


def _apply_table_sorted(skey, counts, lens, rank, next_code, nbins: int):
    """Per-position (code, len) from keys (bin << 15 | pos) sorted per
    row: seed each bin's (len, rank) at its first sorted slot, fill
    forward with a cummax, restore position order with one sort, and
    rebuild the canonical code arithmetically.  Returns (code [B, N]
    bit-reversed, len [B, N]), position-ordered."""
    B = skey.shape[0]
    dev = skey.device
    starts = exclusive(counts, 1)
    pack = (lens[:, :nbins] << 9) | rank[:, :nbins]
    tgt = torch.where(counts > 0, starts, N).to(I64)
    binno = torch.arange(nbins, dtype=I32, device=dev)[None, :]
    seed = torch.full((B, N + 1), -1, dtype=I32, device=dev).scatter(
        1, tgt, (binno << 13) | pack)[:, :N]
    filled = torch.cummax(seed, 1).values & ((1 << 13) - 1)
    pk = torch.where((skey >> 15) < nbins, filled, 0)
    pk = torch.sort(((skey & 0x7FFF) << 13) | pk, dim=1).values
    l = (pk >> 9) & 15
    r = pk & 511
    nc = torch.where(l > 0, torch.gather(next_code, 1, l.to(I64)), 0)
    code = H.bit_reverse(nc + r, l)
    return torch.where(l > 0, code, 0), l


def _choose_one(offset, fb, db, bl, lv, level: int):
    """Pick-min ladder for blocks entering at bit `offset`."""
    pad = (-(offset + 3)) & 7
    stored = 3 + pad + 32 + 8 * bl
    if level == 0:
        choice = torch.full_like(stored, CH_STORED)
    else:
        choice = torch.where(stored <= torch.minimum(fb, db), CH_STORED,
                             torch.where(fb <= db, CH_FIXED, CH_DYN))
    bits = torch.where(choice == CH_STORED, stored,
                       torch.where(choice == CH_FIXED, fb, db))
    bits = torch.where(lv, bits, 0)
    pad = torch.where(lv, pad, 0)
    return choice.to(I32), pad.to(I32), bits.to(I32)


def choose_blocks(fixed_bits, dyn_bits, blens, live, level: int,
                  phase0: int = 0):
    """Stage B: exact per-block type choice + absolute bit offsets.

    A block's bits depend on the running offset only through offset
    mod 8 (stored padding), so each block is a map over the 8 entry
    phases; offsets are the prefix composition of those maps by
    log2(B) doubling rounds.  Returns (choice, pad, offset, bits) [B]."""
    B = fixed_bits.shape[0]
    dev = fixed_bits.device
    ph = torch.arange(8, dtype=I32, device=dev)[None, :]
    _, _, bits8 = _choose_one(ph, fixed_bits[:, None], dyn_bits[:, None],
                              blens[:, None], live[:, None], level)

    def compose(Lm, Rm):
        """(L then R)[p] = L[p] + R[(p + L[p]) & 7]."""
        return Lm + torch.gather(Rm, 1, ((ph + Lm) & 7).to(I64))

    M = bits8
    d = 1
    while d < B:
        top = torch.zeros((min(d, B), 8), dtype=I32, device=dev)
        M = compose(torch.cat([top, M[:-d]]), M)
        d *= 2
    excl = torch.cat([torch.zeros((1, 8), dtype=I32, device=dev), M[:-1]])
    offset = phase0 + excl[:, phase0 & 7]
    choice, pad, bits = _choose_one(offset, fixed_bits, dyn_bits, blens,
                                    live, level)
    return choice, pad, offset.to(I32), bits


def _emit_fields_base(block, blen, plan, choice, pad, bfinal):
    """Stage-C planning, batched: per-position packets (lo, hi, sh) of
    up to 48 bits, the block preamble and dynamic-header entries, and
    the end-of-block code."""
    dev = block.device
    tk = plan["tk"]
    stored = choice == CH_STORED
    fixed = choice == CH_FIXED
    dyn = (choice == CH_DYN)[:, None]

    dyn_lit_rank, dyn_lit_nc = H.canonical_parts(plan["dyn_lit_lens"])
    dyn_dist_codes, _ = H.canonical_codes(plan["dyn_dist_lens"])
    fx_lit = _t(T.FIXED_LITLEN_LENGTHS, dev)
    fx_dist = _t(T.FIXED_DIST_LENGTHS, dev)
    fx_lit_rank, fx_lit_nc = H.canonical_parts(fx_lit)
    fx_dist_codes, _ = H.canonical_codes(fx_dist)

    lit_rank = torch.where(dyn, dyn_lit_rank, fx_lit_rank[:T.NUM_LITLEN])
    lit_nc = torch.where(dyn, dyn_lit_nc, fx_lit_nc)
    lit_lens = torch.where(dyn, plan["dyn_lit_lens"], fx_lit)
    dist_codes = torch.where(dyn, dyn_dist_codes, fx_dist_codes[:30])
    dist_lens = torch.where(dyn, plan["dyn_dist_lens"], fx_dist[:30])

    cnt_l = plan["hist_lit"].clone()
    cnt_l[:, 256] -= 1                              # sorted keys lack EOB
    e_lit_v, e_lit_l = _apply_table_sorted(
        plan["skey_l"], cnt_l[:, :286], lit_lens, lit_rank, lit_nc, 286)
    dpack = dist_codes | (dist_lens << 15)
    dsel = torch.gather(dpack, 1, tk["dcode"].clamp(0, 29).to(I64))
    e_dc_v, e_dc_l = dsel & 0x7FFF, dsel >> 15

    live_tok = tk["mark"] & ~stored[:, None]
    m = tk["is_match"]
    lm = live_tok & m
    e_lit_l = torch.where(live_tok, e_lit_l, 0)
    e_le_v = tk["len"] - _len_base(tk["lcode"])
    e_le_l = torch.where(lm, _len_eb(tk["lcode"]), 0)
    e_dc_l = torch.where(lm, e_dc_l, 0)
    e_de_v = tk["dist"] - _dist_base(tk["dcode"])
    e_de_l = torch.where(lm, _dist_eb(tk["dcode"]), 0)

    # fuse each position's 4 fields into one <=48-bit packet (int64
    # lanes hold the reference's uint32 words)
    lo = torch.zeros(block.shape, dtype=I64, device=dev)
    hi = torch.zeros_like(lo)
    sh = torch.zeros(block.shape, dtype=I32, device=dev)
    for v, l in ((e_lit_v, e_lit_l), (e_le_v, e_le_l),
                 (e_dc_v, e_dc_l), (e_de_v, e_de_l)):
        fld = v.to(I64) & ((1 << torch.clamp(l, max=16).to(I64)) - 1)
        shc = torch.clamp(sh, 0, 31).to(I64)
        in_lo = sh < 32
        lo = lo | torch.where(in_lo, (fld << shc) & M32, 0)
        spill = torch.where(in_lo & (shc > 0),
                            fld >> (32 - torch.clamp(shc, min=1)), 0)
        hi = hi | torch.where(
            in_lo, spill,
            (fld << torch.clamp(sh - 32, 0, 31).to(I64)) & M32)
        sh = sh + l

    btype = torch.where(stored, 0, torch.where(fixed, 1, 2)).to(I32)
    zero = torch.zeros_like(blen)
    hdr3 = torch.stack([bfinal.to(I32) | (btype << 1), zero, blen,
                        blen ^ 0xFFFF], 1)
    s16 = torch.where(stored, 16, 0).to(I32)
    hdr3_l = torch.stack([torch.full_like(blen, 3),
                          torch.where(stored, pad, 0), s16, s16], 1)
    hl = torch.where(dyn, plan["header_lens"], 0)

    eob_l = lit_lens[:, 256]
    eob_len = torch.where(stored, 0, eob_l)
    eob_code = H.bit_reverse(
        torch.gather(lit_nc, 1, eob_l.clamp(0, 15).to(I64)[:, None])[:, 0]
        + lit_rank[:, 256], eob_l)
    ev = eob_code.to(I64) & ((1 << eob_len.to(I64)) - 1)

    return {"lo": wrap32(lo), "hi": wrap32(hi), "sh": sh, "sh_sym": sh,
            "live_tok": live_tok, "is_match": m, "len": tk["len"],
            "stored": stored, "hdr3": hdr3, "hdr3_l": hdr3_l,
            "hv": plan["header_vals"], "hl": hl, "eob_v": wrap32(ev),
            "eob_len": eob_len}


def _comp64(loA, hiA, sA, loB, hiB, sB):
    """Packet B appended after packet A (sA + sB <= 64); lo/hi int64
    holding 32-bit values."""
    sAc = torch.clamp(sA, 0, 31).to(I64)
    lt32 = sA < 32
    loC = torch.where(lt32, loA | ((loB << sAc) & M32), loA)
    spill = torch.where(lt32 & (sA > 0),
                        loB >> (32 - torch.clamp(sAc, min=1)), 0)
    hiC = hiA | torch.where(
        lt32, spill | ((hiB << sAc) & M32),
        (loB << torch.clamp(sA - 32, 0, 31).to(I64)) & M32)
    return loC, hiC, sA + sB


def _emit_fields(block, blen, plan, choice, pad, bfinal):
    """Stage-C planning of the scatter and kernel backends, batched: the
    base fields plus the hierarchical <= 64-bit packet fusion (up to 16
    consecutive tokens in one packet) and n_live [B], the live packets
    left.  sh_sym keeps the per-symbol widths (the decode hints)."""
    f = _emit_fields_base(block, blen, plan, choice, pad, bfinal)
    B = block.shape[0]
    lo, hi, sh = u32(f["lo"]), u32(f["hi"]), f["sh"]
    live_tok = f["live_tok"]
    lr = live_tok & (sh > 0)                       # fusable packets
    # runw: block positions the packet covers (1 for a literal, its length
    # for a match).  A fuse is legal only when the LEFT packet covers its
    # half exactly, so no live token between the halves is reordered.
    runw = torch.where(lr, torch.where(f["is_match"], f["len"], 1), 0)
    for lvl in range(4):
        w = 1 << lvl
        loR, hiR, shR, lrR, lvR, rwR = (
            x.reshape(B, -1, 2 * w).clone()
            for x in (lo, hi, sh, lr, live_tok, runw))
        can = (lrR[..., 0] & lrR[..., w] & (rwR[..., 0] == w)
               & (shR[..., 0] + shR[..., w] <= 64))
        loC, hiC, shC = _comp64(loR[..., 0], hiR[..., 0], shR[..., 0],
                                loR[..., w], hiR[..., w], shR[..., w])
        for R, C in ((loR, loC), (hiR, hiC), (shR, shC),
                     (rwR, w + rwR[..., w])):
            R[..., 0] = torch.where(can, C, R[..., 0])
            R[..., w] = torch.where(can, 0, R[..., w])
        lrR[..., w] &= ~can
        lvR[..., w] &= ~can
        lo, hi, sh, lr, live_tok, runw = (
            x.reshape(B, -1) for x in (loR, hiR, shR, lrR, lvR, rwR))
    return {**f, "lo": wrap32(lo), "hi": wrap32(hi), "sh": sh,
            "live_tok": live_tok, "n_live": live_tok.sum(1).to(I32)}


def _spread(lo, hi, s):
    """(lo, hi) << s over a 3-word window, s in [0, 32); int64 lanes."""
    ns = 32 - torch.clamp(s, min=1)
    c0 = (lo << s) & M32
    c1 = torch.where(s == 0, hi, (lo >> ns) | ((hi << s) & M32))
    c2 = torch.where(s == 0, 0, hi >> ns)
    return c0, c1, c2


def emit_block(blocks, blens, plan, choice, pad, bfinal):
    """Stage C, scatter backend, batched: each block's chosen encoding as
    int32 [B, WB] words."""
    return _emit_scatter(blocks, blens, pad,
                         _emit_fields(blocks, blens, plan, choice, pad,
                                      bfinal))


def _emit_scatter(blocks, blens, pad, f):
    """emit_block from the _emit_fields fields f: the header by
    pack_bits, position pairs fused into 5-word windows and scatter-added
    at their bit offsets (the bits never overlap, so add equals or), then
    the end-of-block code."""
    lo, hi, sh = u32(f["lo"]), u32(f["hi"]), f["sh"].to(I64)
    tok_off = torch.cumsum(sh, 1) - sh
    tok_bits = tok_off[:, -1] + sh[:, -1]
    hdr_words, hdr_bits = BP.pack_bits(
        torch.cat([f["hdr3"], f["hv"]], 1),
        torch.cat([f["hdr3_l"], f["hl"]], 1), WB)

    off = hdr_bits.to(I64)[:, None] + tok_off
    off0 = off[:, 0::2]
    r0 = off0 & 31
    a = _spread(lo[:, 0::2], hi[:, 0::2], r0)
    d = r0 + sh[:, 0::2]                      # second packet's window offset
    k1 = d >> 5                               # 0..2
    b = _spread(lo[:, 1::2], hi[:, 1::2], d & 31)
    zero = torch.zeros_like(b[0])
    bs = [*b, zero, zero]

    def at(j):                                # b[j - k1], 0 out of range
        return torch.where(k1 == 0, bs[j] if j <= 2 else zero,
               torch.where(k1 == 1, bs[j - 1] if 1 <= j <= 3 else zero,
                           bs[j - 2] if j >= 2 else zero))

    # 5 words: a fused-literal pair (60 + 60 bits) at phase 31 spans them
    win = [a[0] | at(0), a[1] | at(1), a[2] | at(2), at(3), at(4)]
    w0 = off0 >> 5
    eob_off = hdr_bits.to(I64) + tok_bits
    er = eob_off & 31
    ev = u32(f["eob_v"])
    idx = torch.cat([w0 + j for j in range(5)]
                    + [(eob_off >> 5)[:, None], (eob_off >> 5)[:, None] + 1],
                    1)
    vals = torch.cat(win + [((ev << er) & M32)[:, None],
                            torch.where(er == 0, 0,
                                        ev >> (32 - torch.clamp(er, min=1))
                                        )[:, None]], 1)
    words = BP.scatter_words(WB, idx, vals)
    words = wrap32(u32(words) + u32(hdr_words))
    nbits = eob_off + f["eob_len"].to(I64)
    return _finish_block(words, blocks, blens, f["stored"], pad, nbits)


def _packet_pre(blocks, blens, plan, choice, pad, bfinal):
    """Stage C (kernel backend) part 1, batched: the fused emission fields
    with the end-of-block code as packet N, and each live packet's
    compaction displacement (delta, -1 for dead lanes)."""
    return _packets_of(_emit_fields(blocks, blens, plan, choice, pad,
                                    bfinal))


def _packets_of(f):
    """_packet_pre from the _emit_fields fields f."""
    B = f["lo"].shape[0]
    dev = f["lo"].device
    hdr_lens = torch.cat([f["hdr3_l"], f["hl"]], 1)
    hmask = torch.where(hdr_lens > 0,
                        (1 << torch.clamp(hdr_lens, max=16)) - 1, 0)
    hdr_lo = torch.cat([f["hdr3"], f["hv"]], 1).to(I32) & hmask
    live = torch.cat([f["live_tok"], ~f["stored"][:, None]], 1)
    lo_t = torch.cat([f["lo"], f["eob_v"][:, None]], 1)
    hi_t = torch.cat([f["hi"], torch.zeros((B, 1), dtype=I32, device=dev)],
                     1)
    sh_t = torch.cat([f["sh"], f["eob_len"][:, None]], 1).to(I32)
    lv = live.to(I32)
    rank = exclusive(lv, 1)
    lane = torch.arange(N + 1, dtype=I32, device=dev)[None, :]
    delta = torch.where(live, lane - rank, -1)
    return {"lo_t": lo_t, "hi_t": hi_t, "sh_t": sh_t, "delta": delta,
            "hdr_lo": hdr_lo, "hdr_lens": hdr_lens.to(I32),
            "n_live": f["n_live"], "stored": f["stored"]}


def _route_packets(pre):
    """Compact every block's live packets to the front of NPK lanes:
    monotone routing (16 rounds) on kernel K3 (CUDA) or its plain
    version (CPU).  Returns (lo, hi, sh) int32 [B, NPK], zero past the
    live packets."""
    padw = PK.NPK - (N + 1)
    p2 = torch.nn.functional.pad
    (slo, shi, ssh), _ = WR.route(
        [p2(pre[k], (0, padw)) for k in ("lo_t", "hi_t", "sh_t")],
        p2(pre["delta"], (0, padw), value=-1), 16, left=True)
    return slo, shi, ssh


def _packet_post(pre, slo, shi, ssh):
    """Stage C (kernel backend) part 2, batched: header entries ahead of
    the routed packets, exclusive bit offsets.  Returns (off, lo, hi
    int32 [B, NPK], count [B] live packets, nbits [B], stored [B])."""
    hdr_lo, hdr_lens = pre["hdr_lo"], pre["hdr_lens"]
    HD = hdr_lo.shape[1]
    take = PK.NPK - HD                      # >= N + 1: every live packet
    all_lo = torch.cat([hdr_lo, slo[:, :take]], 1)
    all_hi = torch.cat([torch.zeros_like(hdr_lo), shi[:, :take]], 1)
    all_sh = torch.cat([hdr_lens, ssh[:, :take]], 1)
    off = exclusive(all_sh, 1)
    nbits = off[:, -1] + all_sh[:, -1]
    count = HD + torch.where(pre["stored"], 0, pre["n_live"] + 1)
    return off, all_lo, all_hi, count.to(I32), nbits, pre["stored"]


def build_packets(blocks, blens, plan, choice, pad, bfinal):
    """Stage C, kernel backend, up to the pack: every block's packet list
    in the contract of ops/pack.py — (off, lo, hi, count, nbits,
    stored)."""
    return _packet_list(_emit_fields(blocks, blens, plan, choice, pad,
                                     bfinal))


def _packet_list(f):
    """build_packets from the _emit_fields fields f."""
    pre = _packets_of(f)
    return _packet_post(pre, *_route_packets(pre))


def _emit_kernel(blocks, blens, pad, f):
    """Stage C, kernel backend, from the _emit_fields fields f: packets
    compacted on K3, placed on K7, then the stored payloads and the
    end mask."""
    off, lo, hi, counts, nbits, stored = _packet_list(f)
    words = PK.pack_blocks(counts, off, lo, hi)[:, :WB]
    return _finish_block(words, blocks, blens, stored, pad, nbits)


def _finish_block(words, block, blen, stored, pad, nbits):
    """Stage-C tail, batched: inject stored payloads (whole-block funnel
    shift) and zero the bits past each block's end."""
    dev = words.device
    w = LZ._aligned_words(block)                    # [B, N/4] int64
    t = (35 + pad).to(I64)[:, None]                 # payload bit 35..42
    r = t & 31
    prev = torch.cat([torch.zeros_like(w[:, :1]), w[:, :-1]], 1)
    rs = 32 - torch.clamp(r, min=1)
    sh = ((w << r) & M32) | torch.where(r == 0, 0, prev >> rs)
    tail = torch.where(r == 0, 0, w[:, -1:] >> rs)
    st = stored[:, None]
    inject = torch.cat([torch.zeros_like(w[:, :1]),
                        torch.where(st, sh, 0), torch.where(st, tail, 0),
                        torch.zeros((w.shape[0], WB - w.shape[1] - 2),
                                    dtype=I64, device=dev)], 1)
    out = u32(words) | inject
    end = torch.where(stored, t[:, 0] + 8 * blen.to(I64), nbits.to(I64))
    widx = torch.arange(WB, dtype=I64, device=dev)[None, :]
    e5, e31 = (end >> 5)[:, None], (end & 31)[:, None]
    keep = torch.where(widx < e5, M32,
                       torch.where(widx == e5, (1 << e31) - 1, 0))
    return wrap32(out & keep)


def _emit_merge_batch(blocks, blens, pad, f):
    """Stage C: assemble every block's bitstream (header <> tokens <>
    EOB) from the _emit_fields_base fields f by direct bit placement.
    Returns int32 [B, WB]."""
    B = blocks.shape[0]
    tokw, tokb = BM.merge_bitstream(f["lo"], f["hi"], f["sh"], leaf_bits=48,
                                    density=16, slack=32, cap_bits=32 * WB)
    hdr_lens = torch.cat([f["hdr3_l"], f["hl"]], 1)
    hmask = torch.where(hdr_lens > 0,
                        (1 << torch.clamp(hdr_lens, max=16)) - 1, 0)
    hdr_lo = torch.cat([f["hdr3"], f["hv"]], 1) & hmask
    NH = hdr_lo.shape[1]
    P2 = 1 << (NH - 1).bit_length()
    hdr_cap = 16 * NH
    padw = torch.nn.functional.pad
    hdrw, hdrb = BM.merge_bitstream(
        padw(hdr_lo, (0, P2 - NH)), None, padw(hdr_lens, (0, P2 - NH)),
        leaf_bits=16, density=16, slack=0, cap_bits=hdr_cap)
    out = padw(hdrw, (0, WB - hdrw.shape[1]))
    out = BM.place_at(out, tokw, hdrb)
    nb0 = (hdrb + tokb).to(I64)
    ev = u32(f["eob_v"])
    r = nb0 & 31
    q = (nb0 >> 5)[:, None]
    add = torch.cat([(ev << r) & M32, (ev << r) >> 32])      # lo, hi words
    flat = torch.cat([u32(out), torch.zeros((B, 1), dtype=I64,
                                            device=out.device)], 1)
    flat = flat.scatter_add(1, torch.cat([q, q + 1], 1),
                            add.reshape(2, B).T.contiguous())[:, :WB]
    nbits = nb0 + f["eob_len"].to(I64)
    return _finish_block(wrap32(flat), blocks, blens, f["stored"], pad,
                         nbits)


def block_hints(sh, stored, W64cap: int = W64CAP):
    """Per-64-bit-chunk entry phases for the wavefront decoder, batched:
    hint[w] = bit phase of the first symbol starting in chunk w,
    HINT_NONE past the EOB and for stored blocks.  sh [B, N] per-symbol
    widths; stored [B]."""
    B = sh.shape[0]
    dev = sh.device
    sh64 = sh.to(I64)
    tok_off = torch.cumsum(sh64, 1) - sh64
    eob_off = tok_off[:, -1:] + sh64[:, -1:]
    offs = torch.cat([tok_off, eob_off], 1)
    chunk = offs >> 6
    prev = torch.cat([torch.full((B, 1), -1, dtype=I64, device=dev),
                      chunk[:, :-1]], 1)
    flag = chunk != prev
    rank = torch.cumsum(flag.to(I64), 1) - flag.to(I64)
    ok = flag & (rank < W64cap)
    hints = torch.full((B, W64cap + 1), HINT_NONE, dtype=I32, device=dev)
    hints.scatter_(1, torch.where(ok, rank, W64cap),
                   torch.where(ok, offs & 63, HINT_NONE).to(I32))
    hints = hints[:, :W64cap]
    return torch.where(stored[:, None], HINT_NONE, hints)


PACKS = ("merge", "scatter", "kernel")


def _encode(blocks, blens, live, final_idx: int, level: int, phase0: int,
            want_hints: bool, pack: str | None = None):
    """pack: emission backend (PACKS), None for "merge", the reference's
    default.  The reference also picks a Huffman-tree backend per pack; the
    port has one (K1 on the card, its plain version on the CPU)."""
    pack = pack or "merge"
    if pack not in PACKS:
        raise ValueError(f"unknown pack backend {pack!r}")
    B = blocks.shape[0]
    plans = batch_plan(blocks, blens, level)
    with metrics.span("encode.choose"):
        choice, pad, offset, bits = choose_blocks(
            plans["fixed_bits"], plans["dyn_bits"], blens, live, level,
            phase0)
    with metrics.span("encode.emit"):
        bfinal = torch.arange(B, device=blocks.device) == final_idx
        if pack == "merge":
            f = _emit_fields_base(blocks, blens, plans, choice, pad, bfinal)
            words = _emit_merge_batch(blocks, blens, pad, f)
        else:
            f = _emit_fields(blocks, blens, plans, choice, pad, bfinal)
            emit = _emit_scatter if pack == "scatter" else _emit_kernel
            words = emit(blocks, blens, pad, f)
        words = torch.where(live[:, None], words, 0)
        # the first block's sub-byte entry phase is baked into its own bits
        out, total = BM.merge_words(words, bits, B * WB)
    hints = None
    if want_hints:
        with metrics.span("encode.hints"):
            # from the per-symbol widths, not the fused packets' widths
            hints = block_hints(f["sh_sym"], f["stored"])
    return out, total, offset, bits, hints


def encode_batch(blocks, blens, live, final_idx: int, level: int,
                 phase0: int = 0, pack: str | None = None):
    """Encode B blocks into one contiguous bitstream segment.

    blocks uint8 [B, 32768] (zero padded), blens int32 [B], live bool [B]
    (padding blocks excluded), final_idx: index of the BFINAL block or
    -1, phase0: absolute bit offset of the segment in the stream, pack:
    emission backend ("merge", the default for None; "scatter";
    "kernel"), all bit-identical.  Returns (words int32 [B*WB],
    total_bits int32)."""
    return _encode(blocks, blens, live, final_idx, level, phase0,
                   False, pack)[:2]


def encode_batch_with_offsets(blocks, blens, live, final_idx: int,
                              level: int, phase0: int = 0,
                              pack: str | None = None):
    """encode_batch plus per-block absolute offsets and bits [B]."""
    return _encode(blocks, blens, live, final_idx, level, phase0,
                   False, pack)[:4]


def encode_batch_with_hints(blocks, blens, live, final_idx: int,
                            level: int, phase0: int = 0,
                            pack: str | None = None):
    """encode_batch_with_offsets plus the per-block wavefront decode
    hints int32 [B, 4224]."""
    return _encode(blocks, blens, live, final_idx, level, phase0, True,
                   pack)


def plan_sizes(blocks, blens, live, level: int):
    """Size-only planning (no emission) at stream phase 0: stage A, then
    choose_blocks' (choice, pad, offset, bits) [B].  Used by
    compress(stats=...) and the tests."""
    plans = batch_plan(blocks, blens, level)
    return choose_blocks(plans["fixed_bits"], plans["dyn_bits"], blens, live,
                         level)


def encode_blocks_multi(blocks, blens, live, finals, owner, level: int):
    """Encode blocks of MANY independent streams in one batch.

    finals: bool [B], the block carries BFINAL (last block of its
    stream); owner: int32 [B], stream id per block (a stream's blocks
    contiguous).  Each stream starts at bit phase 0: choose_blocks'
    doubling composes the blocks' phase maps as a segmented scan that
    restarts at every change of owner.  Every block's words come back
    standalone (scatter emission) for the host to stitch per stream.
    Returns (words int32 [B, WB], bits int32 [B])."""
    B = blocks.shape[0]
    dev = blocks.device
    plans = batch_plan(blocks, blens, level)
    fb, db = plans["fixed_bits"], plans["dyn_bits"]
    ph = torch.arange(8, dtype=I32, device=dev)[None, :]
    start = owner != torch.cat([torch.full((1,), -1, dtype=owner.dtype,
                                           device=dev), owner[:-1]])
    _, _, bits8 = _choose_one(ph, fb[:, None], db[:, None], blens[:, None],
                              live[:, None], level)
    # a stream's first block enters at phase 0 whatever came before
    M = torch.where(start[:, None], bits8[:, :1], bits8)
    S = start
    d = 1
    while d < B:
        Lm = torch.cat([torch.zeros((min(d, B), 8), dtype=I32, device=dev),
                        M[:-d]])
        Ls = torch.cat([torch.zeros(min(d, B), dtype=torch.bool,
                                    device=dev), S[:-d]])
        comp = Lm + torch.gather(M, 1, ((ph + Lm) & 7).to(I64))
        M = torch.where(S[:, None], M, comp)
        S = S | Ls
        d *= 2
    excl = torch.cat([torch.zeros((1, 8), dtype=I32, device=dev), M[:-1]])
    offset = torch.where(start, 0, excl[:, 0])
    choice, pad, bits = _choose_one(offset, fb, db, blens, live, level)
    words = emit_block(blocks, blens, plans, choice, pad, finals)
    return torch.where(live[:, None], words, 0), bits
