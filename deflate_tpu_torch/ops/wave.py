"""Wavefront INFLATE: hint-assisted, vectorized DEFLATE decode.

Port of deflate_tpu/ops/wave.py.  Pipeline per bucket of B independent
self-contained blocks (this package's encoder guarantees no cross-block
references):

  host   : parse block headers -> per-block canonical-decode scalars
           (first/lim per code length, class boundaries, symbol
           membership bitmasks); extract bit-normalized body windows.
  A+B    : decode at the chunk's symbol starts, hint-seeded 64-step mark
           automaton, per-chunk sums, within-chunk compaction — kernel
           K2 (ops/wave_stagea.py); or, with DT_STAGEAB_PALLAS=0, stage
           A at all 64 bit phases on kernel K8 and the rest in torch.
  C      : chunk-level exclusive sums (output offsets, symbol indices).
  D      : route chunk-compact symbol records to dense slots — kernel K3
           (ops/wave_route.py).
  E      : literal byte values by 256-bit membership-mask rank-select
           — kernel K11 (csrc/wave_glue.cu).
  F      : route records to output-byte slots (K3, rightward); match
           records compacted (K3), then chains at one distance merged
           and the records re-compacted — kernel K12 (csrc/wave_glue.cu).
  G      : LZ match fill — kernel K4 (ops/wave_fill.py), in
           models/wave_decoder.py.

The per-chunk entry phases ("hints") come from the encoder through the
manifest, or from hints_from_walk_host for hintless streams.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from deflate_tpu_torch import _build
from deflate_tpu_torch.models import host_inflate as HI
from deflate_tpu_torch.utils import metrics
from deflate_tpu_torch.utils import tables as T
from deflate_tpu_torch.utils.bits import I32, exclusive, srl

HINT_NONE = 255          # hint sentinel: no symbol starts in this chunk
NS = 33 * 1024           # symbol-domain slots per block (<=32768 emitters
                         # +1 EOB)
CCAP = 16                # symbol slots per 64-bit chunk after the within-
                         # chunk compaction; wave_decode flags a chunk
                         # with more starts as a block error (callers fall
                         # back to the host decoder)
ND = 32768               # output bytes per block
NM = 11264               # match-record slots (>= 32768/3 + 1)
MD_KEYS = ("l_lim", "l_first", "l_meta", "l_mask",
           "d_lim", "d_first", "d_mask")


# ====================== host-side metadata ================================
def _canon_meta(lengths: np.ndarray, nlit_split: bool):
    """Per-length canonical-decode scalars for one code.

    Returns dict of [16] int32 arrays:
      lim[l], first[l], base[l]  — compare-decode (c < lim -> length l;
                                   rank = base + c - first)
      meta[l]  — packed class boundaries: nlit(9) | has_eob(1)<<9
                 | nsym...(for dist codes meta is unused)
      mask[l]  — length-symbol membership bitmask (litlen: bit j =
                 symbol 257+j has this length; dist: bit j = symbol j)
      litmask[l] — [16, 8] int32, 256-bit literal membership per length
    plus 'err' bool (oversubscribed / unusable code).

    zlib's incomplete-code allowance (single code of length 1) is
    accepted; decode of the missing code flags invalid downstream.
    """
    lengths = np.asarray(lengths, np.int64)
    n = len(lengths)
    cnt = np.bincount(lengths, minlength=16)[:16].copy()
    cnt[0] = 0
    err = False
    kraft = int(np.sum(cnt[1:] * (1 << (15 - np.arange(1, 16)))))
    npresent = int(cnt.sum())
    if npresent and kraft > (1 << 15):
        err = True
    first = np.zeros(16, np.int64)
    code = 0
    for l in range(1, 16):
        code = (code + cnt[l - 1]) << 1
        first[l] = code
    lim = first + cnt
    base = np.cumsum(cnt) - cnt
    meta = np.zeros(16, np.int64)
    mask = np.zeros(16, np.int64)
    litmask = np.zeros((16, 8), np.int64)
    for l in range(1, 16):
        syms = np.nonzero(lengths == l)[0]
        if nlit_split:
            nlit = int((syms < 256).sum())
            has_eob = int((syms == 256).any())
            meta[l] = nlit | (has_eob << 9)
            for s in syms[syms > 256]:
                mask[l] |= 1 << (int(s) - 257)
            for s in syms[syms < 256]:
                litmask[l, int(s) >> 5] |= 1 << (int(s) & 31)
        else:
            for s in syms:
                mask[l] |= 1 << int(s)
    return {
        "lim": lim.astype(np.int64), "first": first, "base": base,
        "meta": meta, "mask": mask, "litmask": litmask, "err": err,
    }


def _u32(a):
    return np.asarray(a, np.uint64).astype(np.uint32).view(np.int32)


@functools.lru_cache(maxsize=1)
def _fixed_meta():
    lit = _canon_meta(np.asarray(T.FIXED_LITLEN_LENGTHS), True)
    dst = _canon_meta(np.asarray(T.FIXED_DIST_LENGTHS[:30]), False)
    return lit, dst


class _HostBits:
    """Minimal LSB-first bit reader over bytes (header parse only)."""

    __slots__ = ("data", "pos")

    def __init__(self, data, pos=0):
        self.data = data
        self.pos = pos

    def read(self, n):
        p = self.pos
        acc = int.from_bytes(self.data[p >> 3:(p >> 3) + 6], "little")
        self.pos = p + n
        return (acc >> (p & 7)) & ((1 << n) - 1)


def parse_headers_host(stream: bytes, bit_offsets):
    """Parse B block headers on the host; return stacked per-block
    metadata (numpy): canonical-decode scalars l_*/d_* [B, 16] (and
    l_litmask [B, 16, 8]) as int32 bit patterns, btype, data_start
    (absolute bit of the first symbol, or of a stored payload),
    stored_len and hdr_err [B].

    The native library walks the sequential header bits
    (native.parse_headers, dt_parse_headers) and _canon_meta_batch
    computes the canonical-decode scalars in vectorised numpy.  Unlike
    the reference, which takes its pure-Python walk when the library
    does not load, a library that fails to build or load raises here:
    the port's skeleton walk needs the same library, so there is no
    quiet slow path.  _parse_headers_host_py stays as the differential
    oracle of the tests."""
    from deflate_tpu_torch import native

    return _canon_meta_batch(native.parse_headers(stream, bit_offsets))


def _canon_meta_batch(raw):
    """Vectorised _canon_meta over the native header walk's raw output.

    raw: dict from native.parse_headers (btype, data_start, stored_len,
    err, hlit, hdist, lens [B, 320] uint8).  Returns the exact
    parse_headers_host dict (held against _parse_headers_host_py by the
    tests)."""
    B = len(raw["btype"])
    lens = raw["lens"].astype(np.int64)          # [B, 320]
    hlit = raw["hlit"].astype(np.int64)
    hdist = raw["hdist"].astype(np.int64)
    is_fixed = raw["btype"] == 1
    if is_fixed.any():
        lens = lens.copy()
        lens[is_fixed, :288] = np.asarray(T.FIXED_LITLEN_LENGTHS, np.int64)
        lens[is_fixed, 288:318] = np.asarray(T.FIXED_DIST_LENGTHS[:30],
                                             np.int64)
        hlit = np.where(is_fixed, 288, hlit)
        hdist = np.where(is_fixed, 30, hdist)

    rows = np.arange(B)[:, None]
    Ll = np.where(np.arange(288)[None, :] < hlit[:, None], lens[:, :288], 0)
    Ld = lens[rows, np.minimum(hlit[:, None] + np.arange(32)[None, :], 319)]
    Ld = np.where(np.arange(32)[None, :] < hdist[:, None], Ld, 0)[:, :30]

    def counts(L):
        """[B, 16] number of symbols of each length (length 0 not
        counted)."""
        cnt = np.bincount((L + 16 * rows).ravel(),
                          minlength=16 * B).reshape(B, 16).astype(np.int64)
        cnt[:, 0] = 0
        return cnt

    def canon(L):
        cnt = counts(L)
        kraft = (cnt[:, 1:] << (15 - np.arange(1, 16))[None, :]).sum(1)
        oversub = (cnt.sum(1) > 0) & (kraft > (1 << 15))
        first = np.zeros((B, 16), np.int64)
        code = np.zeros(B, np.int64)
        for l in range(1, 16):
            code = (code + cnt[:, l - 1]) << 1
            first[:, l] = code
        return first, first + cnt, np.cumsum(cnt, axis=1) - cnt, oversub

    l_first, l_lim, l_base, ov_l = canon(Ll)
    d_first, d_lim, d_base, ov_d = canon(Ld)

    # meta: literals of each length | has_eob << 9
    meta = counts(Ll[:, :256]) | ((np.arange(16)[None, :]
                                   == Ll[:, 256:257]).astype(np.int64) << 9)
    meta[:, 0] = 0

    def bitmask(M, nbits):
        """[B, 16] masks: bit j of mask[:, l] is (M[:, j] == l)."""
        out = np.zeros((B, 16), np.int64)
        w = (1 << np.arange(nbits, dtype=np.int64))[None, :]
        for l in range(1, 16):
            out[:, l] = ((M == l) * w).sum(1)
        return out

    litmask = np.zeros((B, 16, 8), np.int64)
    for l in range(1, 16):
        bits = np.ascontiguousarray(Ll[:, :256] == l)
        litmask[:, l, :] = np.packbits(bits, axis=1, bitorder="little") \
            .view("<u4").astype(np.int64)

    is_huff = (raw["btype"] == 1) | (raw["btype"] == 2)
    res = {"l_lim": l_lim, "l_first": l_first, "l_base": l_base,
           "l_meta": meta, "l_mask": bitmask(Ll[:, 257:288], 31),
           "l_litmask": litmask, "d_lim": d_lim, "d_first": d_first,
           "d_base": d_base, "d_mask": bitmask(Ld, 30)}
    res = {k: _u32(v) for k, v in res.items()}
    res["btype"] = raw["btype"].astype(np.int64)
    res["data_start"] = raw["data_start"].astype(np.int64)
    res["stored_len"] = raw["stored_len"].astype(np.int64)
    res["hdr_err"] = (raw["err"] | (is_huff & (ov_l | ov_d))).astype(bool)
    return res


def _parse_headers_host_py(stream: bytes, bit_offsets):
    """Pure-Python per-block walk: the differential oracle of
    parse_headers_host (the reference's fallback, kept for the tests)."""
    B = len(bit_offsets)
    btype = np.zeros(B, np.int64)
    dstart = np.zeros(B, np.int64)
    stored_len = np.zeros(B, np.int64)
    err = np.zeros(B, bool)
    keys = ("l_lim", "l_first", "l_base", "l_meta", "l_mask",
            "d_lim", "d_first", "d_base", "d_mask")
    out = {k: np.zeros((B, 16), np.int64) for k in keys}
    out["l_litmask"] = np.zeros((B, 16, 8), np.int64)
    fx_l, fx_d = _fixed_meta()

    for b, off in enumerate(bit_offsets):
        br = _HostBits(stream, int(off))
        br.read(1)                               # BFINAL
        bt = br.read(2)
        btype[b] = bt
        if bt == 0:
            p = (br.pos + 7) & ~7
            ln = _HostBits(stream, p).read(16)
            nlen = _HostBits(stream, p + 16).read(16)
            if ln ^ nlen != 0xFFFF or (p + 32 + 8 * ln) > 8 * len(stream):
                err[b] = True
            stored_len[b] = ln
            dstart[b] = p + 32                   # payload start (byte al.)
            continue
        if bt == 3:
            err[b] = True
            continue
        if bt == 1:
            lm, dm = fx_l, fx_d
            dstart[b] = br.pos
        else:
            lm, dm, end = _parse_dynamic_meta(stream, br.pos)
            if lm is None:
                err[b] = True
                continue
            dstart[b] = end
        for pre, m in (("l_", lm), ("d_", dm)):
            for k in ("lim", "first", "base", "mask"):
                out[pre + k][b] = m[k]
            if pre == "l_":
                out["l_meta"][b] = m["meta"]
                out["l_litmask"][b] = m["litmask"]
            err[b] |= m["err"]

    res = {k: _u32(v) for k, v in out.items()}
    res["btype"] = btype.astype(np.int64)
    res["data_start"] = dstart.astype(np.int64)
    res["stored_len"] = stored_len.astype(np.int64)
    res["hdr_err"] = err
    return res


def _parse_dynamic_meta(stream: bytes, hdr_start_bit: int):
    """Re-parse a dynamic header's code lengths into _canon_meta form."""
    br = HI._BitReader(stream)
    br.pos = hdr_start_bit
    try:
        hlit = br.read(5) + 257
        hdist = br.read(5) + 1
        hclen = br.read(4) + 4
        cl_lens = np.zeros(19, np.int64)
        for k in range(hclen):
            cl_lens[T.CL_ORDER[k]] = br.read(3)
        cl = HI._Canon(cl_lens)
        lens = np.zeros(hlit + hdist, np.int64)
        i = 0
        while i < hlit + hdist:
            s = cl.decode(br)
            if s < 16:
                lens[i] = s
                i += 1
            elif s == 16:
                if i == 0:
                    return None, None, 0
                rep = 3 + br.read(2)
                lens[i:i + rep] = lens[i - 1]
                i += rep
            elif s == 17:
                i += 3 + br.read(3)
            else:
                i += 11 + br.read(7)
        if i != hlit + hdist or lens[256] == 0:
            return None, None, 0
    except HI.InflateError:
        return None, None, 0
    return (_canon_meta(lens[:hlit], True),
            _canon_meta(lens[hlit:hlit + hdist], False), br.pos)


def prepare_windows(stream: bytes, data_starts, W64: int):
    """Extract + bit-normalize each block's body window on the host.

    Returns nwords [B, 2*W64+4] int32 with block b's body bit i at bit
    (i&31) of word i>>5.  numpy (one pass over ~B * window bytes).
    """
    data_starts = np.asarray(data_starts, np.int64)
    B = len(data_starts)
    W32 = 2 * W64 + 4
    pad = (-len(stream)) % 4
    words = np.frombuffer(stream + b"\x00" * pad, np.uint8).view(np.uint32)
    words = np.concatenate([words, np.zeros(W32 + 2, np.uint32)])
    w0 = (data_starts >> 5).astype(np.int64)
    sh = (data_starts & 31).astype(np.uint32)
    idx = w0[:, None] + np.arange(W32 + 1)[None, :]
    win = words[idx]                                   # [B, W32+1]
    shc = sh[:, None]
    lo = win[:, :W32] >> shc
    hi = np.where(shc == 0, 0,
                  win[:, 1:] << (32 - np.maximum(shc, 1)))
    return (lo | hi).view(np.int32)


# ====================== elementwise primitives ============================
def popcount32(x):
    """SWAR popcount of int32 lanes."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    return (x + (x >> 16)) & 0x3F


def select_bit32(m, j):
    """Index of the j-th (0-based) set bit of m — branchless binary
    descent over halves; in-range garbage if j >= popcount."""
    idx = torch.zeros_like(j)
    for h in (16, 8, 4, 2, 1):
        low = m & ((1 << h) - 1)
        c = popcount32(low)
        go = (j >= c).to(I32)
        j = j - go * c
        m = torch.where(go > 0, m >> h, low)
        idx = idx + go * h
    return idx


def route_monotone_left(payloads, delta, rounds: int):
    """Stable monotone routing: the element at slot i moves LEFT by
    delta[i] (delta < 0: empty slot), LSB-first log-shift rounds.
    Destinations must be strictly increasing and delta non-decreasing
    over occupied slots.  payloads: list of int32 tensors, routed axis
    last.  Returns (payloads, delta_out), delta_out 0 where an element
    landed; other slots hold what the rounds left there.  The plain
    version of kernel K3 (ops/wave_route.py)."""
    def sl(a, s):                       # a[..., j+s] with tail padding
        pad = torch.full(a.shape[:-1] + (s,), -1, dtype=a.dtype,
                         device=a.device)
        return torch.cat([a[..., s:], pad], -1)

    for k in range(rounds):
        s = 1 << k
        dsh = sl(delta, s)
        inc = (dsh >= 0) & (((dsh >> k) & 1) > 0)
        out = (delta >= 0) & (((delta >> k) & 1) > 0)
        payloads = [torch.where(inc, sl(p, s), p) for p in payloads]
        delta = torch.where(inc, dsh - s, torch.where(out, -1, delta))
    return payloads, delta


def route_monotone_right(payloads, delta, rounds: int):
    """Mirror of route_monotone_left: elements move RIGHT by delta,
    MSB-first rounds (the order that keeps rightward moves
    collision-free)."""
    def sr(a, s):                       # a[..., j-s] with head padding
        pad = torch.full(a.shape[:-1] + (s,), -1, dtype=a.dtype,
                         device=a.device)
        return torch.cat([pad, a[..., :-s]], -1)

    for k in reversed(range(rounds)):
        s = 1 << k
        dsh = sr(delta, s)
        inc = (dsh >= 0) & (((dsh >> k) & 1) > 0)
        out = (delta >= 0) & (((delta >> k) & 1) > 0)
        payloads = [torch.where(inc, sr(p, s), p) for p in payloads]
        delta = torch.where(inc, dsh - s, torch.where(out, -1, delta))
    return payloads, delta


# ====================== stage A: per-position decode ======================
def build_peeks(nwords, W64: int):
    """Peek windows from normalized block windows nwords [B, 2*W64+4]
    (body bit i at bit (i&31) of word i>>5).  Returns PK, PKH [B, 64,
    W64]: PK[b,p,w] = 32 bits from position 64w+p, PKH the next 32."""
    we = nwords[:, 0:2 * W64:2]
    wo = nwords[:, 1:2 * W64 + 1:2]
    w2 = nwords[:, 2:2 * W64 + 2:2]
    w3 = nwords[:, 3:2 * W64 + 3:2]
    pk_rows, pkh_rows = [], []
    for p in range(64):
        if p == 0:
            pk_rows.append(we)
            pkh_rows.append(wo)
        elif p < 32:
            pk_rows.append(srl(we, p) | (wo << (32 - p)))
            pkh_rows.append(srl(wo, p) | (w2 << (32 - p)))
        elif p == 32:
            pk_rows.append(wo)
            pkh_rows.append(w2)
        else:
            q = p - 32
            pk_rows.append(srl(wo, q) | (w2 << (32 - q)))
            pkh_rows.append(srl(w2, q) | (w3 << (32 - q)))
    return torch.stack(pk_rows, 1), torch.stack(pkh_rows, 1)


def _canon_decode(PK, g, lim_key, first_key, extra_keys, maxl=15):
    """Compare-based canonical decode at every position.  g(key, l) is
    the per-block scalar for code length l, broadcastable against PK.
    Returns (found, len, rank within the length class, selected
    extra_keys values)."""
    z = torch.zeros_like(PK)
    c = z
    found = torch.zeros(PK.shape, dtype=torch.bool, device=PK.device)
    rsel = z
    sels = [z for _ in extra_keys]
    for l in range(1, maxl + 1):
        c = (c << 1) | (srl(PK, l - 1) & 1)
        hit = (~found) & (c < g(lim_key, l))
        rsel = torch.where(hit, c - (g(first_key, l) - (l << 10)), rsel)
        for i, k in enumerate(extra_keys):
            sels[i] = torch.where(hit, g(k, l), sels[i])
        found = found | hit
    return found, srl(rsel, 10), rsel & 1023, sels


def lit_fields(PK, g, maxl: int = 15):
    """decode_core's litlen half: (found, len, rank, is_lit, is_eob,
    is_m, extra bits, base length) from the low maxl bits of PK."""
    found, len_, r_rel, (metasel, masksel) = _canon_decode(
        PK, g, "l_lim", "l_first", ["l_meta", "l_mask"], maxl)

    nlit = metasel & 0x1FF
    has_eob = srl(metasel, 9) & 1
    is_lit = found & (r_rel < nlit)
    is_eob = found & (has_eob > 0) & (r_rel == nlit)
    is_m = found & ~is_lit & ~is_eob

    j_len = torch.clamp(r_rel - nlit - has_eob, 0, 28)
    li = select_bit32(masksel, j_len)                      # 0..28
    li4 = srl(li - 4, 2)
    ebits = torch.where((li < 8) | (li == 28), 0, li4)
    lbase = torch.where(li < 8, 3 + li,
                        torch.where(li == 28, 258,
                                    3 + ((4 + (li & 3))
                                         << torch.clamp(li4, 0, 5))))
    return found, len_, r_rel, is_lit, is_eob, is_m, ebits, lbase


def dist_fields(pk2, g, maxd: int = 15):
    """decode_core's distance half: (found, len, extra bits, base
    distance) from the low maxd bits of pk2."""
    dfound, dlen, dr_rel, (dmasksel,) = _canon_decode(
        pk2, g, "d_lim", "d_first", ["d_mask"], maxd)
    dsym = select_bit32(dmasksel, dr_rel)                  # 0..29
    dh = torch.clamp(srl(dsym, 1) - 1, 0, 13)
    debits = torch.where(dsym < 4, 0, dh)
    dbase = torch.where(dsym < 4, 1 + dsym, 1 + ((2 + (dsym & 1)) << dh))
    return dfound, dlen, debits, dbase


def decode_core(PK, PKH, g, maxl: int = 15, maxd: int = 15):
    """Stage-A math on peek windows (elementwise, any shape).

    maxl/maxd bound the litlen/dist compare rounds (rounds past a
    table's longest code never hit).  Returns packed int32 arrays:
      A0 = advance(6) | emit(9)<<6 | class(2)<<15 | X(9)<<17 | len(4)<<26
           X = rank for literals, length-3 for matches; class 0=lit
           1=match 2=EOB 3=invalid;
      P1 = dist(15).
    """
    found, len_, r_rel, is_lit, is_eob, is_m, ebits, lbase = lit_fields(
        PK, g, maxl)
    lextra = srl(PK, len_) & ((1 << ebits) - 1)
    length = torch.where(is_m, lbase + lextra, 1)

    adv1 = len_ + torch.where(is_m, ebits, 0)
    a1c = torch.clamp(adv1, 1, 24)
    pk2 = srl(PK, a1c) | (PKH << (32 - a1c))
    dfound, dlen, debits, dbase = dist_fields(pk2, g, maxd)
    dextra = srl(pk2, torch.clamp(dlen, 1, 28)) & ((1 << debits) - 1)
    dist = torch.where(is_m, dbase + dextra, 0)

    invalid = (~found) | (is_m & ~dfound)
    advance = torch.where(is_m, adv1 + dlen + debits, len_)
    advance = torch.clamp(advance, 1, 63)
    emit = torch.where(is_lit, 1, torch.where(is_m, length, 0))
    cls = torch.where(invalid, 3,
                      torch.where(is_eob, 2, torch.where(is_m, 1, 0)))
    X = torch.where(is_m, torch.clamp(length - 3, 0, 255), r_rel)
    A0 = advance | (emit << 6) | (cls << 15) | (X << 17) | (len_ << 26)
    return A0.to(I32), dist.to(I32)


def stack_md(md) -> torch.Tensor:
    """The decode_core tables as one int32 [B, 7, 16] tensor."""
    return torch.stack([md[k].to(I32) for k in MD_KEYS], 1)


def decode_positions(nwords, mds, W64: int, maxl: int = 15,
                     maxd: int = 15):
    """Stage A at every bit position: A0, P1 each [B, 64, W64].
    mds: stack_md output [B, >=7, 16]."""
    PK, PKH = build_peeks(nwords, W64)
    B = PK.shape[0]
    ki = {k: i for i, k in enumerate(MD_KEYS)}

    def g(key, l):
        return mds[:, ki[key], l].reshape(B, 1, 1)

    return decode_core(PK, PKH, g, maxl, maxd)


# ====================== stage B: chunk automaton ==========================
def chunk_automaton(A0, hints, W64: int):
    """Within-chunk mark automaton, one 64-step pass seeded by the
    per-chunk entry-phase hints.  Returns (sums dict of [B, W64],
    rank_rows [B, 64, W64] — within-chunk symbol rank per position)."""
    B = A0.shape[0]
    z = torch.zeros((B, W64), dtype=I32, device=A0.device)
    h = hints
    Mlo = torch.where(h < 32, 1 << torch.clamp(h, 0, 31), 0)
    Mhi = torch.where((h >= 32) & (h < 64),
                      1 << torch.clamp(h - 32, 0, 31), 0)
    Clo = Chi = se = sc = sm = sb = si = z
    rank_rows = []
    for t in range(64):
        a = A0[:, t, :]
        bit = (srl(Mlo, t) if t < 32 else srl(Mhi, t - 32)) & 1
        adv_t = a & 63
        emit_t = srl(a, 6) & 511
        cls_t = srl(a, 15) & 3
        rank_rows.append(sc)
        live = bit & (1 - (cls_t >= 2).to(I32))
        nt = t + adv_t
        if t < 31:
            Mlo = Mlo | torch.where(nt < 32,
                                    live << torch.clamp(nt, 0, 31), 0)
        Mhi = Mhi | torch.where((nt >= 32) & (nt < 64),
                                live << torch.clamp(nt - 32, 0, 31), 0)
        Clo = Clo | torch.where((nt >= 64) & (nt < 96),
                                live << torch.clamp(nt - 64, 0, 31), 0)
        Chi = Chi | torch.where(nt >= 96,
                                live << torch.clamp(nt - 96, 0, 31), 0)
        se = se + bit * emit_t
        sc = sc + bit
        sm = sm + bit * (cls_t == 1).to(I32)
        sb = sb + bit * (cls_t == 2).to(I32)
        si = si + bit * (cls_t == 3).to(I32)
    sums = {"Mlo": Mlo, "Mhi": Mhi, "Clo": Clo, "Chi": Chi,
            "sum_emit": se, "sum_cnt": sc, "sum_match": sm,
            "sum_eob": sb, "sum_inv": si}
    return {k: v.to(I32) for k, v in sums.items()}, torch.stack(rank_rows, 1)


def chunk_compact(A0, P1, rank_rows, mk):
    """Within-chunk symbol compaction: chunk w's rank-j marked position
    lands at [b, j, w] of [B, CCAP, W64] arrays, by six monotone
    log-shift rounds along the phase axis (ranks >= CCAP are dropped)."""
    B, _, W64 = A0.shape
    t_row = torch.arange(64, dtype=I32, device=A0.device)[None, :, None]
    d = torch.where(mk, t_row - rank_rows, -1)
    a, p = A0, P1
    for k in range(6):
        s = 1 << k

        def sh(x, fill):
            pad = torch.full((B, s, W64), fill, dtype=x.dtype,
                             device=x.device)
            return torch.cat([x[:, s:], pad], 1)

        ds = sh(d, -1)
        inc = (ds >= 0) & (((ds >> k) & 1) > 0)
        out = (d >= 0) & (((d >> k) & 1) > 0)
        a = torch.where(inc, sh(a, 0), a)
        p = torch.where(inc, sh(p, 0), p)
        d = torch.where(inc, ds - s, torch.where(out, -1, d))
    return a[:, :CCAP], p[:, :CCAP]


def _unpack_marks(Mlo, Mhi, W64: int):
    rows = [(srl(Mlo, t) & 1) if t < 32 else (srl(Mhi, t - 32) & 1)
            for t in range(64)]
    return torch.stack(rows, 1)                       # [B, 64, W64]


# ====================== stages C-F: assembly ==============================
RUN_TILE = 256          # merge_match_runs' rounds pair records only
                        # inside aligned tiles of this many


def resolve_litval(len_, r_rel, litmask):
    """Literal byte value = r_rel-th set bit of the 256-bit literal
    membership mask for code length len_; litmask int32 [B, 16, 8].
    CUDA tensors run kernel K11, CPU tensors the plain version."""
    with metrics.span("wave.resolve_litval"):
        fn = resolve_litval_kernel if len_.is_cuda else resolve_litval_plain
        return fn(len_, r_rel, litmask)


def resolve_litval_plain(len_, r_rel, litmask):
    """The plain version of K11: for len_ outside 1..15, or r_rel at or
    past the mask's popcount, the deterministic garbage K11 repeats."""
    B = len_.shape[0]
    shape = (B,) + (1,) * (len_.ndim - 1)
    mw = [torch.zeros_like(len_) for _ in range(8)]
    for l in range(1, 16):
        hit = len_ == l
        for q in range(8):
            mw[q] = torch.where(hit, litmask[:, l, q].reshape(shape),
                                mw[q])
    j = r_rel
    acc = torch.zeros_like(j)
    found = torch.zeros(j.shape, dtype=torch.bool, device=j.device)
    word = torch.zeros_like(j)
    jrel = torch.zeros_like(j)
    wq = torch.zeros_like(j)
    for q in range(8):
        pc = popcount32(mw[q])
        sel = (~found) & (j < acc + pc)
        word = torch.where(sel, mw[q], word)
        jrel = torch.where(sel, j - acc, jrel)
        wq = torch.where(sel, q, wq)
        found = found | sel
        acc = acc + pc
    return (wq << 5) + select_bit32(word, jrel)


@functools.lru_cache(maxsize=None)
def _glue_entry(name: str):
    """The ctypes function of csrc/wave_glue.cu's `name`, resolved once."""
    return getattr(_build.lib("wave_glue"), name)


def resolve_litval_kernel(len_, r_rel, litmask):
    """K11 on the card: same contract as resolve_litval_plain, for len_
    and r_rel of one shape [B, ...] (one row a block: the trailing
    dimensions are flattened)."""
    if (len_.ndim < 1 or r_rel.shape != len_.shape
            or tuple(litmask.shape) != (len_.shape[0], 16, 8)):
        raise ValueError(f"K11 takes len_ and r_rel of one shape [B, ...] "
                         f"and litmask [B, 16, 8]; got {tuple(len_.shape)},"
                         f" {tuple(r_rel.shape)}, {tuple(litmask.shape)}")
    len_, r_rel = len_.contiguous(), r_rel.contiguous()
    litmask = litmask.contiguous()
    dev = _build.require_cuda(len_, r_rel, litmask)
    B = len_.shape[0]
    out = torch.empty_like(len_)
    if out.numel():
        _build.check(_glue_entry("dt_resolve_litval")(
            len_.data_ptr(), r_rel.data_ptr(), litmask.data_ptr(),
            out.data_ptr(), B, out.numel() // B, _build.stream_ptr(dev)),
            "dt_resolve_litval")
        metrics.count("kernel.K11")
    return out


def merge_match_runs(rec0, rec1):
    """Fuse adjacent same-distance match records into run records (a run
    at one distance writes the same bytes as its pieces), then compact
    the records left.  rec0 = opos | len3<<16 (len3 grows to 16 bits),
    rec1 = dist, [B, N] with N a multiple of RUN_TILE.  Returns (rec0,
    rec1, nmatch).  CUDA tensors run kernel K12, CPU tensors the plain
    version."""
    with metrics.span("wave.merge_match_runs"):
        fn = merge_match_runs_kernel if rec0.is_cuda \
            else merge_match_runs_plain
        return fn(rec0, rec1)


def merge_match_runs_plain(rec0, rec1):
    """The plain version of K12: eight halving rounds, then a
    re-compaction on the route (K3 for CUDA tensors)."""
    from deflate_tpu_torch.ops.wave_route import route

    B = rec0.shape[0]
    span = (rec0 >= 0).to(I32)
    L0, D = rec0, rec1
    for lvl in range(8):
        w = 1 << lvl
        l0 = L0.reshape(B, -1, 2 * w).clone()
        dd = D.reshape(B, -1, 2 * w).clone()
        sp = span.reshape(B, -1, 2 * w).clone()
        lef0, rig0 = l0[:, :, 0].clone(), l0[:, :, w].clone()
        can = ((sp[:, :, 0] == w) & (sp[:, :, w] > 0)
               & (dd[:, :, 0] == dd[:, :, w]) & (dd[:, :, 0] > 0)
               & ((rig0 & 0xFFFF)
                  == (lef0 & 0xFFFF) + srl(lef0, 16) + 3))
        mlen3 = srl(lef0, 16) + srl(rig0, 16) + 3
        l0[:, :, 0] = torch.where(can, (lef0 & 0xFFFF) | (mlen3 << 16),
                                  lef0)
        l0[:, :, w] = torch.where(can, -1, rig0)
        dd[:, :, w] = torch.where(can, 0, dd[:, :, w])
        sp0 = sp[:, :, 0].clone()
        sp[:, :, 0] = torch.where(can, sp0 + sp[:, :, w], sp0)
        sp[:, :, w] = torch.where(can, 0, sp[:, :, w])
        L0 = l0.reshape(B, -1)
        D = dd.reshape(B, -1)
        span = sp.reshape(B, -1)
    lv = (L0 >= 0).to(I32)
    rank = exclusive(lv, 1)
    lane = torch.arange(L0.shape[1], dtype=I32, device=L0.device)[None, :]
    dmv = torch.where(lv > 0, lane - rank, -1)
    (L0, D), dmo = route([L0, D], dmv, int(L0.shape[1] - 1).bit_length(),
                         left=True)
    L0 = torch.where(dmo == 0, L0, -1)
    D = torch.where(dmo == 0, D, 0)
    return L0, D, lv.sum(1).to(I32)


def merge_match_runs_kernel(rec0, rec1):
    """K12 on the card: same contract as merge_match_runs_plain.  One
    allocation holds the three outputs; they are views of it."""
    if rec0.ndim != 2 or rec1.shape != rec0.shape \
            or rec0.shape[1] % RUN_TILE:
        raise ValueError(f"K12 takes rec0 and rec1 of one shape [B, N], N "
                         f"a multiple of {RUN_TILE}; got "
                         f"{tuple(rec0.shape)}, {tuple(rec1.shape)}")
    rec0, rec1 = rec0.contiguous(), rec1.contiguous()
    dev = _build.require_cuda(rec0, rec1)
    B, N = rec0.shape
    buf = torch.empty(B * (2 * N + 1), dtype=I32, device=dev)
    out0, out1 = buf[:2 * B * N].view(2, B, N).unbind(0)
    nmatch = buf[2 * B * N:]
    if B:
        _build.check(_glue_entry("dt_merge_runs")(
            rec0.data_ptr(), rec1.data_ptr(), out0.data_ptr(),
            out1.data_ptr(), nmatch.data_ptr(), B, N,
            _build.stream_ptr(dev)), "dt_merge_runs")
        metrics.count("kernel.K12")
    return out0, out1, nmatch


def wave_decode(nwords, hints, out_expect, md, W64: int, stop_bit=None,
                maxl: int = 15, maxd: int = 15):
    """Stages A-F on one bucket of B Huffman blocks, on nwords' device.

    nwords int32 [B, 2*W64+4] normalized windows; hints int32 [B, W64];
    out_expect int32 [B] expected produced bytes; md: dict of per-block
    tables (parse_headers_host keys, as int32 tensors); stop_bit int32
    [B] or None: a synthetic EOB at that body bit (-1: none).

    Stages A+B run fused on kernel K2; with the environment variable
    DT_STAGEAB_PALLAS=0 (read at each call, as the reference reads it)
    they take the reference's unfused route instead: stage A alone on
    kernel K8, then the mark automaton and compaction in torch.

    Returns (litwords int32 [B, ND//4] — literal bytes placed, match
    bytes zero; rec0, rec1 [B, NM] match records (opos | len3<<16,
    dist); nmatch [B]; produced [B]; err [B] int32)."""
    with metrics.span("decode.stages"):
        from deflate_tpu_torch.ops import wave_stagea as WS
        from deflate_tpu_torch.ops.wave_route import route

        B = nwords.shape[0]
        dev = nwords.device
        fused = bool(int(os.environ.get("DT_STAGEAB_PALLAS", "1")))
        mark = WS.decode_mark if fused else WS.decode_mark_split
        A0c, P1c, sums = mark(nwords, hints, stack_md(md), W64, stop_bit,
                              maxl, maxd)
        sstart = exclusive(sums["sum_cnt"], 1)
        produced = sums["sum_emit"].sum(1).to(I32)
        nsym = sstart[:, -1] + sums["sum_cnt"][:, -1]
        nmatch = sums["sum_match"].sum(1).to(I32)

        # ---- chain validation: carry of chunk w-1 must equal hint of w ----
        h = hints
        elo = torch.where(h < 32, 1 << torch.clamp(h, 0, 31), 0)
        ehi = torch.where((h >= 32) & (h < 64),
                          1 << torch.clamp(h - 32, 0, 31), 0)
        zcol = torch.zeros((B, 1), dtype=I32, device=dev)
        cin_lo = torch.cat([zcol, sums["Clo"][:, :-1]], 1)
        cin_hi = torch.cat([zcol, sums["Chi"][:, :-1]], 1)
        mism = (cin_lo != elo) | (cin_hi != ehi)
        err = mism[:, 1:].any(1)
        err = err | (h[:, 0] != 0)                        # chain starts at 0
        err = err | (sums["sum_inv"].sum(1) > 0)
        err = err | (sums["sum_eob"].sum(1) != 1)
        err = err | (produced != out_expect)
        err = err | (nsym > NS)
        err = err | (nmatch > NM)
        err = (err | (sums["sum_cnt"] > CCAP).any(1)).to(I32)

        # ---- stage D: route chunk-compact symbol groups to dense slots ---
        # chunk w's cnt[w] symbols sit at lanes w*CCAP.. of the w-major
        # view; the group moves left by w*CCAP - sstart[w]
        L = W64 * CCAP

        def flatc(a):
            return a.transpose(1, 2).reshape(B, L)

        cnt_rep = torch.repeat_interleave(sums["sum_cnt"], CCAP, dim=1)
        dval = (torch.arange(W64, dtype=I32, device=dev) * CCAP)[None, :] \
            - sstart
        delta = torch.repeat_interleave(dval, CCAP, dim=1)
        j_lane = torch.arange(CCAP, dtype=I32, device=dev).repeat(W64)[None, :]
        delta = torch.where(j_lane < cnt_rep, delta, -1)
        (P0, P1f), dout = route([flatc(A0c), flatc(P1c)], delta,
                                int(L - 1).bit_length(), left=True)
        if L < NS:
            pad = NS - L
            P0 = torch.nn.functional.pad(P0, (0, pad))
            P1f = torch.nn.functional.pad(P1f, (0, pad))
            dout = torch.nn.functional.pad(dout, (0, pad), value=-1)
        P0, P1f, dout = P0[:, :NS], P1f[:, :NS], dout[:, :NS]
        valid = dout == 0

        # ---- stage E: unpack + literal values at symbol domain -----------
        emit_s = torch.where(valid, srl(P0, 6) & 511, 0)
        cls = srl(P0, 15) & 3
        X = srl(P0, 17) & 511
        len_s = srl(P0, 26) & 15
        is_lit_s = valid & (cls == 0)
        is_m_s = valid & (cls == 1)
        opos = exclusive(emit_s, 1)
        mi = exclusive(is_m_s.to(I32), 1)
        litval = resolve_litval(len_s, X, md["l_litmask"].to(I32))

        # ---- match records: compact to [B, NM] ---------------------------
        j_sym = torch.arange(NS, dtype=I32, device=dev)[None, :]
        d4 = torch.where(is_m_s, j_sym - mi, -1)
        (rec0, rec1), d4o = route([opos | (X << 16), P1f], d4,
                                  int(NS - 1).bit_length(), left=True)
        rec0 = torch.where(d4o[:, :NM] == 0, rec0[:, :NM], -1)
        rec1 = torch.where(d4o[:, :NM] == 0, rec1[:, :NM], 0)
        rec0, rec1, nmatch = merge_match_runs(rec0, rec1)

        # ---- stage F: place literal bytes at output offsets --------------
        d2 = torch.where(is_lit_s, opos - j_sym, -1)
        (vout,), d2o = route([litval], d2, int(NS - 1).bit_length(),
                             left=False)
        lb = torch.where(d2o == 0, vout, 0)[:, :ND].reshape(B, ND // 4, 4)
        litwords = (lb[:, :, 0] | (lb[:, :, 1] << 8)
                    | (lb[:, :, 2] << 16) | (lb[:, :, 3] << 24))
        return litwords, rec0, rec1, nmatch, produced, err


# ====================== host reference hint walk ==========================
def hints_from_walk_host(stream: bytes, bit_offsets, W64cap: int = 4224):
    """Reference hint generator: sequentially walk each block's symbols
    on the host and record each 64-bit chunk's entry phase.

    The encoder emits these for free (models/encoder.py); this walk
    exists for foreign self-contained streams and as the test oracle.
    Returns (hints uint8 [B, W64cap], span_bits int64 [B] — body bits
    incl. EOB, for bucket selection; stored blocks get span 0).
    """
    md = parse_headers_host(stream, bit_offsets)
    B = len(bit_offsets)
    hints = np.full((B, W64cap), HINT_NONE, np.uint8)
    span = np.zeros(B, np.int64)
    for b in range(B):
        if md["btype"][b] == 0 or md["hdr_err"][b]:
            continue
        ds = int(md["data_start"][b])
        br = HI._BitReader(stream)
        br.pos = ds
        if md["btype"][b] == 1:
            lit, dist = HI._fixed_tables()
        else:
            hb = HI._BitReader(stream)
            hb.pos = int(bit_offsets[b]) + 3
            lit, dist = HI._read_dynamic_tables(hb)
        while True:
            p = br.pos - ds
            w = p >> 6
            if w < W64cap and hints[b, w] == HINT_NONE:
                hints[b, w] = p & 63
            s = lit.decode(br)
            if s == 256:
                span[b] = br.pos - ds
                break
            if s > 256:
                br.read(int(T.LENGTH_EXTRA[s - 257]))
                d = dist.decode(br)
                br.read(int(T.DIST_EXTRA[d]))
    return hints, span
