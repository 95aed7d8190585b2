"""Kernel K6: full inflate of self-contained DEFLATE blocks
(csrc/block_inflate.cu).

Replaces deflate_tpu/ops/pallas_inflate.py (`_kernel`, wrappers
`_inflate_blocks_jit` and `inflate_blocks`), the table-driven decoder of
the TPU scalar core.  Per block: header parse (stored / fixed /
dynamic, RFC 1951 3.2.3-3.2.7), zlib-style two-level canonical decode
tables (root 9 litlen, root 6 dist) for dynamic blocks, then the symbol
loop with match copies into the block's 32 KiB of output.  Blocks must
be self-contained: a distance reaching before the block start is an
error, as are every other malformed condition (module constants below).

The host side (constants, table-entry format, ``build_table_host``,
``make_statics``, ``prepare_blocks``) is copied from the reference;
``prepare_blocks`` keeps its window arithmetic (1024-word aligned
``start_w``, ``bit0``, and the ``avail`` cap of (IN_W - 3) * 32 bits past
``start_w``), because that cap decides ``err`` for long blocks.  It drops
the reference's chain padding and span ordering, which served the TPU's
K-chain interleaving.

``inflate_blocks_plain`` is a straightforward per-block loop over the
same tables, with the kernel's error set; CUDA tensors run K6.  The
contract is produced, err and end bit per block plus out[:produced];
where err is set only err is meaningful.  ``inflate_blocks_records`` is
the kernel's design in plain form: the same loop emits literals and
match records (``decode_tokens``), and K4's pointer jumping
(``wave_fill.fill_matches_jump``) resolves the copies.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from deflate_tpu_torch import _build
from deflate_tpu_torch.ops import wave_fill as WF
from deflate_tpu_torch.ops.wave import NM
from deflate_tpu_torch.utils import metrics
from deflate_tpu_torch.utils import tables as T

# ---- static geometry (pallas_inflate.py:46-75) ---------------------------
IN_W = 10240              # input window words per block (40 KiB)
OUT_W = 8192              # output words per block (32 KiB)
OUT_BYTES = OUT_W * 4

LT_ROOT = 9               # litlen root table bits (zlib ENOUGH_LENS=852)
DT_ROOT = 6               # dist root table bits (zlib ENOUGH_DISTS=592)
LT_SIZE = 896
DT_SIZE = 704
TAB_SLOT = LT_SIZE + DT_SIZE          # one block's table slot
CL_SIZE = 128             # code-length-code table (root 7, complete)
LENS_W = 320              # code-length scratch (286+30 <= 316)
STATICS_W = 2048          # fixed tables + constants

# const layout inside the statics tail (at TAB_SLOT)
C_CL_ORDER = 0            # 19 words: CL permutation
C_LITPAY = 32             # 288 words: per-symbol litlen payloads
C_DISTPAY = 320           # 32 words: per-symbol dist payloads

# ---- table entry format v2 (pallas_inflate.py:80-111) --------------------
# link entries are NEGATIVE: sign | (sub_bits << 16) | sub_table_index
# symbol entries are non-negative:  payload | nbits
#   litlen payload: [4:0]=nbits  [7:5]=len extra bits  [16:8]=base
#                   [18:17]=class (0 literal/CL, 1 length, 2 EOB, 3 bad)
#   dist payload:   [4:0]=nbits  [8:5]=dist extra bits [23:9]=base
#                   (invalid dist symbols get extra-bits sentinel 15)
CLS_LIT, CLS_LEN, CLS_EOB, CLS_BAD = 0, 1, 2, 3
INVALID = CLS_BAD << 17
D_INVALID = 15 << 5

MAX_ACTIONS = 65536       # loop-step cap per block (a literal pair or
                          # <= 8 bytes of a match per step)


def _litlen_payload(sym):
    if sym < 256:
        return (CLS_LIT << 17) | (sym << 8)
    if sym == 256:
        return CLS_EOB << 17
    if sym <= 285:
        li = sym - 257
        return ((CLS_LEN << 17) | (int(T.LENGTH_BASE[li]) << 8)
                | (int(T.LENGTH_EXTRA[li]) << 5))
    return CLS_BAD << 17


def _dist_payload(sym):
    if sym <= 29:
        return (int(T.DIST_BASE[sym]) << 9) | (int(T.DIST_EXTRA[sym]) << 5)
    return D_INVALID


def _cl_payload(sym):
    return sym << 8                       # raw value in the base field


# ===================== host-side table construction =======================
def build_table_host(lens, root, cap, payload=_cl_payload,
                     fill=INVALID):
    """NumPy zlib-style table builder (pallas_inflate.py:120-187): the
    fixed-code statics, and the plain version's dynamic tables.

    Returns (table int32 [cap], err bool); err flags over-subscription
    and table overflow only (the caller checks completeness)."""
    lens = np.asarray(lens, np.int32)
    n = len(lens)
    cnt = np.zeros(16, np.int64)
    for l in lens:
        cnt[l] += 1
    npresent = n - cnt[0]
    tab = np.full(cap, fill, np.int32)
    if npresent == 0:
        return tab, False
    maxlen = max(l for l in lens if l > 0) if npresent else 0
    left = 1
    for l in range(1, 16):
        left = (left << 1) - cnt[l]
        if left < 0:
            return tab, True           # oversubscribed
    # canonical order: counting sort by (len, sym)
    offs = np.zeros(17, np.int64)
    for l in range(1, 16):
        offs[l + 1] = offs[l] + cnt[l]
    work = np.zeros(n, np.int64)
    for sym in range(n):
        if lens[sym]:
            work[offs[lens[sym]]] = sym
            offs[lens[sym]] += 1
    huff = 0                           # bit-reversed code accumulator
    cur_low, cur_off, cur_bits = -1, 0, 0
    next_sub = 1 << root
    err = False
    rem = cnt.copy()                   # remaining-code counts: zlib sizes
    for si in range(npresent):         # each sub-table for the codes NOT
        sym = int(work[si])            # yet placed (count[len]-- in
        l = int(lens[sym])             # inflate_table), so decrement below
        if l <= root:
            entry = payload(sym) | l
            for hi in range(1 << (root - l)):
                tab[huff + (hi << l)] = entry
        else:
            low = huff & ((1 << root) - 1)
            if low != cur_low:
                curr = l - root
                left2 = 1 << curr
                while curr + root < maxlen:
                    left2 -= rem[curr + root]
                    if left2 <= 0:
                        break
                    curr += 1
                    left2 <<= 1
                if next_sub + (1 << curr) > cap:
                    return tab, True
                tab[low] = -(1 << 31) | (curr << 16) | next_sub
                cur_low, cur_off, cur_bits = low, next_sub, curr
                next_sub += 1 << curr
            entry = payload(sym) | (l - root)
            idx0 = huff >> root
            for hi in range(1 << (cur_bits - (l - root))):
                tab[cur_off + idx0 + (hi << (l - root))] = entry
        rem[l] -= 1
        incr = 1 << (l - 1)
        while huff & incr:
            incr >>= 1
        huff = 0 if incr == 0 else (huff & (incr - 1)) + incr
    return tab, err


@functools.lru_cache(maxsize=1)
def make_statics():
    """Fixed-code tables + RFC constant arrays [STATICS_W] int32: fixed
    litlen table at 0, fixed dist table at LT_SIZE, constants at
    TAB_SLOT (pallas_inflate.py:190-207)."""
    out = np.zeros(STATICS_W, np.int32)
    lit, e1 = build_table_host(np.asarray(T.FIXED_LITLEN_LENGTHS),
                               LT_ROOT, LT_SIZE, _litlen_payload)
    dst, e2 = build_table_host(np.asarray(T.FIXED_DIST_LENGTHS[:30]),
                               DT_ROOT, DT_SIZE, _dist_payload, D_INVALID)
    assert not (e1 or e2)
    out[:LT_SIZE] = lit
    out[LT_SIZE:TAB_SLOT] = dst
    c = TAB_SLOT
    out[c + C_CL_ORDER:c + C_CL_ORDER + 19] = np.asarray(T.CL_ORDER)
    out[c + C_LITPAY:c + C_LITPAY + 286] = np.asarray(
        [_litlen_payload(s) for s in range(286)], np.int64).astype(np.int32)
    out[c + C_DISTPAY:c + C_DISTPAY + 30] = np.asarray(
        [_dist_payload(s) for s in range(30)], np.int64).astype(np.int32)
    return out


# ===================== host prep ==========================================
def prepare_blocks(stream: bytes, bit_offsets):
    """Kernel operands for blocks starting at `bit_offsets` (absolute bit
    of each BFINAL bit): stream words int32 [NW] (zero-padded by a whole
    window), start_w int32 [B] (1024-word aligned window start), bit0
    int32 [B] (block start relative to start_w), avail int32 [B] (bits
    readable past start_w: the stream's end, capped at (IN_W - 3) * 32)."""
    nbits = len(stream) * 8
    offs = np.asarray(bit_offsets, np.int64)
    start_w = ((offs // 32) // 1024 * 1024).astype(np.int64)
    bit0 = (offs - 32 * start_w).astype(np.int32)
    avail = np.minimum(nbits - 32 * start_w, (IN_W - 3) * 32).astype(np.int32)
    pad = (-len(stream)) % 4
    words = np.frombuffer(stream + b"\x00" * pad, np.uint8).view(np.int32)
    words = np.concatenate([words, np.zeros(IN_W + 8, np.int32)])
    return words, start_w.astype(np.int32), bit0, avail


# ===================== plain version ======================================
def _build_checked(lens, root, cap, payload, fill, is_cl):
    """build_table_host plus the kernel's completeness rules: incomplete
    codes are errors, except a single code of length 1 in a litlen/dist
    table; an empty CL code is an error."""
    tab, err = build_table_host(lens, root, cap, payload, fill)
    lens = np.asarray(lens, np.int64)
    cnt = np.bincount(lens, minlength=16)
    npresent = len(lens) - cnt[0]
    left, maxlen = 1, 0
    for l in range(1, 16):
        left = (left << 1) - int(cnt[l])
        if cnt[l]:
            maxlen = l
    err = err or left < 0
    err = err or (left != 0 and npresent > 0 and (is_cl or maxlen != 1))
    err = err or (is_cl and npresent == 0)
    return tab, err


def _probe(tab, base, pk, root, subcap):
    """Two-level table probe of the low bits of pk; returns (entry,
    nbits)."""
    e = int(tab[base + (pk & ((1 << root) - 1))])
    if e < 0:
        sb = min((e >> 16) & 31, subcap)
        e = int(tab[base + (e & 0x3FF) + ((pk >> root) & ((1 << sb) - 1))])
        return e, (e & 31) + root
    return e, e & 31


def _copy_match(out: bytearray, opos: int, length: int, dist: int):
    """The byte-sequential LZ77 copy."""
    src = opos - dist
    if dist >= length:
        out[opos:opos + length] = out[src:src + length]
    else:
        for j in range(length):
            out[opos + j] = out[src + j]


def _inflate_one(win: bytes, bit0: int, avail: int, statics: np.ndarray,
                 on_match=_copy_match):
    """One block from its window bytes; returns (out bytearray, produced,
    err, end bit relative to the window).  Each valid match calls
    on_match(out, opos, length, dist), which copies its bytes (the
    default) or, in K6's decomposition, records it."""
    def peek(bp, n=64):
        v = int.from_bytes(win[bp >> 3:(bp >> 3) + 9], "little") >> (bp & 7)
        return v & ((1 << n) - 1)

    out = bytearray(OUT_BYTES)
    bp = bit0 + 1                                  # BFINAL
    btype = peek(bp, 2)
    bp += 2
    if btype == 0:
        bp = (bp + 7) & ~7
        slen, nlen = peek(bp, 16), peek(bp + 16, 16)
        bp += 32
        if ((slen ^ nlen) != 0xFFFF or bp + 8 * slen > avail
                or slen > OUT_BYTES):
            return out, 0, 1, bp
        out[:slen] = win[bp >> 3:(bp >> 3) + slen]
        return out, slen, 0, bp + 8 * slen
    if btype == 3:
        return out, 0, 1, bp
    c = TAB_SLOT
    if btype == 1:
        tab = statics
        lbase, dbase = 0, LT_SIZE
    else:
        nlit, ndist, ncl = peek(bp, 5) + 257, peek(bp + 5, 5) + 1, \
            peek(bp + 10, 4) + 4
        bp += 14
        if nlit > 286 or ndist > 30:
            return out, 0, 1, bp
        lens = np.zeros(LENS_W, np.int64)
        for t in range(ncl):
            lens[statics[c + C_CL_ORDER + t]] = peek(bp, 3)
            bp += 3
        cl_tab, err = _build_checked(lens[:19], 7, CL_SIZE, _cl_payload,
                                     INVALID, True)
        if err:
            return out, 0, 1, bp
        ntot = nlit + ndist
        i = 0
        while i < ntot:
            e = int(cl_tab[peek(bp, 7)])
            if (e >> 17) & 3 or e < 0:
                return out, 0, 1, bp
            bp += e & 31
            sym = (e >> 8) & 0x1FF
            if sym < 16:
                lens[i] = sym
                i += 1
                continue
            if sym == 16:
                cnt = 3 + peek(bp, 2)
                bp += 2
                if i == 0 or i + cnt > ntot:
                    return out, 0, 1, bp
                lens[i:i + cnt] = lens[i - 1]
            else:
                cnt = 3 + peek(bp, 3) if sym == 17 else 11 + peek(bp, 7)
                bp += 3 if sym == 17 else 7
                if i + cnt > ntot:
                    return out, 0, 1, bp
                lens[i:i + cnt] = 0
            i += cnt
        if bp > avail or lens[256] == 0:
            return out, 0, 1, bp
        lit, e1 = _build_checked(
            lens[:nlit], LT_ROOT, LT_SIZE,
            lambda s: int(statics[c + C_LITPAY + s]), INVALID, False)
        dst, e2 = _build_checked(
            lens[nlit:ntot], DT_ROOT, DT_SIZE,
            lambda s: int(statics[c + C_DISTPAY + s]), D_INVALID, False)
        if e1 or e2:
            return out, 0, 1, bp
        tab = np.concatenate([lit, dst])
        lbase, dbase = 0, LT_SIZE

    opos = 0
    steps = 0
    while True:
        if steps >= MAX_ACTIONS:
            return out, opos, 1, bp
        steps += 1
        pk = peek(bp)
        e, nb = _probe(tab, lbase, pk, LT_ROOT, 6)
        cls = (e >> 17) & 3
        base = (e >> 8) & 0x1FF
        if (cls == CLS_LIT and e >= 0 and bp + nb <= avail
                and opos < OUT_BYTES):
            # a literal, and the next symbol too when it is one (one
            # loop step, as the kernel counts them)
            out[opos] = base
            f, nb2 = _probe(tab, lbase, pk >> nb, LT_ROOT, 6)
            if ((f >> 17) & 3 == CLS_LIT and f >= 0
                    and bp + nb + nb2 <= avail and opos + 2 <= OUT_BYTES):
                out[opos + 1] = (f >> 8) & 0x1FF
                bp += nb2
                opos += 1
            bp += nb
            opos += 1
            continue
        if e < 0 or cls == CLS_BAD or cls == CLS_LIT:
            return out, opos, 1, bp
        if cls == CLS_EOB:
            if bp + nb > avail:
                return out, opos, 1, bp
            return out, opos, 0, bp + nb
        eb = (e >> 5) & 7
        length = base + ((pk >> nb) & ((1 << eb) - 1))
        k = nb + eb
        de, dnb = _probe(tab, dbase, pk >> k, DT_ROOT, 9)
        deb = (de >> 5) & 15
        dist = ((de >> 9) & 0x7FFF) + ((pk >> (k + dnb)) & ((1 << deb) - 1))
        bp3 = bp + k + dnb + deb
        if (de < 0 or deb == 15 or dist > opos or bp3 > avail
                or opos + length > OUT_BYTES):
            return out, opos, 1, bp
        # steps: the first <= 8 bytes with the symbol, then 8 per step
        steps += -(-max(length - 8, 0) // 8)
        if steps > MAX_ACTIONS:
            return out, opos, 1, bp
        on_match(out, opos, length, dist)
        opos += length
        bp = bp3


def inflate_blocks_plain(words, start_w, bit0, avail, statics):
    """Decode B blocks (operands of prepare_blocks, as int32 tensors on
    any device).  Returns (out int32 [B, OUT_W], status int32 [B, 3] =
    produced, err, end bit relative to 32 * start_w)."""
    dev = words.device
    wb = words.cpu().numpy().tobytes()
    st = statics.cpu().numpy()
    B = start_w.shape[0]
    out = np.zeros((B, OUT_BYTES), np.uint8)
    status = np.zeros((B, 3), np.int32)
    for b, (sw, b0, av) in enumerate(zip(start_w.tolist(), bit0.tolist(),
                                         avail.tolist())):
        win = wb[4 * sw:4 * (sw + IN_W)]
        o, produced, err, end = _inflate_one(win, b0, av, st)
        out[b] = np.frombuffer(bytes(o), np.uint8)
        status[b] = (produced, err, end)
    return (torch.from_numpy(out.view(np.int32)).to(dev),
            torch.from_numpy(status).to(dev))


def decode_tokens(words, start_w, bit0, avail, statics):
    """The decode half of K6's design, on the host: each block's literal
    row (literal and stored bytes placed, zero elsewhere) and its match
    records, from the loop and error set of inflate_blocks_plain.
    Returns numpy (lit uint8 [B, OUT_BYTES], rec0 int32 [B, NM] = opos |
    len3<<16, rec1 int32 [B, NM] = dist, nmatch [B], status int32 [B, 3])."""
    wb = words.cpu().numpy().tobytes()
    st = statics.cpu().numpy()
    B = start_w.shape[0]
    lit = np.zeros((B, OUT_BYTES), np.uint8)
    rec0 = np.zeros((B, NM), np.int32)
    rec1 = np.zeros((B, NM), np.int32)
    nmatch = np.zeros(B, np.int32)
    status = np.zeros((B, 3), np.int32)
    for b, (sw, b0, av) in enumerate(zip(start_w.tolist(), bit0.tolist(),
                                         avail.tolist())):
        recs = []
        o, produced, err, end = _inflate_one(
            wb[4 * sw:4 * (sw + IN_W)], b0, av, st,
            lambda out, opos, length, dist: recs.append(
                (opos | (length - 3) << 16, dist)))
        lit[b] = np.frombuffer(bytes(o), np.uint8)
        if recs:
            rec0[b, :len(recs)], rec1[b, :len(recs)] = zip(*recs)
        nmatch[b] = len(recs)
        status[b] = (produced, err, end)
    return lit, rec0, rec1, nmatch, status


def inflate_blocks_records(words, start_w, bit0, avail, statics):
    """K6's design in plain form: decode_tokens, then the records packed
    (wave_fill.pack_fill_recs) and resolved by wave_fill.fill_matches_jump,
    K4's pointer jumping.  A block's matches never overlap and never reach
    before the block, so this equals inflate_blocks_plain."""
    lit, rec0, rec1, nmatch, status = decode_tokens(words, start_w, bit0,
                                                    avail, statics)
    recs = WF.pack_fill_recs(torch.from_numpy(rec0), torch.from_numpy(rec1))
    out = WF.fill_matches_jump(torch.from_numpy(lit.view(np.int32)), recs,
                               torch.from_numpy(nmatch))
    dev = words.device
    return out.to(dev), torch.from_numpy(status).to(dev)


def inflate_blocks_kernel(words, start_w, bit0, avail, statics):
    """K6 on the card: same contract as inflate_blocks_plain; the design
    of inflate_blocks_records (decode to literals and match records, then
    K4's pointer-jumping fill), with a scratch of NM records a block."""
    words, start_w, bit0, avail, statics = (
        x.to(torch.int32).contiguous()
        for x in (words, start_w, bit0, avail, statics))
    dev = _build.require_cuda(words, start_w, bit0, avail, statics)
    B = start_w.shape[0]
    if bit0.shape != (B,) or avail.shape != (B,) \
            or statics.shape != (STATICS_W,) or words.dim() != 1:
        raise ValueError("inflate operands must be words [NW], start_w, "
                         "bit0, avail [B] and statics [2048]")
    out = torch.empty((B, OUT_W), dtype=torch.int32, device=dev)
    status = torch.empty((B, 3), dtype=torch.int32, device=dev)
    if B:
        recs = torch.empty((B, 2 * NM), dtype=torch.int32, device=dev)
        err = _build.lib("block_inflate").dt_inflate_blocks(
            words.data_ptr(), start_w.data_ptr(), bit0.data_ptr(),
            avail.data_ptr(), statics.data_ptr(), out.data_ptr(),
            status.data_ptr(), recs.data_ptr(), words.shape[0], B,
            _build.stream_ptr(dev))
        _build.check(err, "dt_inflate_blocks")
        metrics.count("kernel.K6")
    return out, status


def inflate_blocks_op(words, start_w, bit0, avail, statics):
    """CUDA tensors run K6; CPU tensors the plain version."""
    fn = inflate_blocks_kernel if words.is_cuda else inflate_blocks_plain
    return fn(words, start_w, bit0, avail, statics)


def inflate_blocks(stream: bytes, bit_offsets, device="cuda"):
    """Decode B independent DEFLATE blocks of one stream on `device`.

    bit_offsets: absolute bit position of each block's BFINAL bit.
    Returns numpy (out uint8 [B, 32768], produced int32 [B], err int32
    [B], end_bit int64 [B] absolute bit position after each block)."""
    words, start_w, bit0, avail = prepare_blocks(stream, bit_offsets)
    dev = _build.torch_device(device)
    out, status = inflate_blocks_op(
        *(torch.from_numpy(x).to(dev)
          for x in (words, start_w, bit0, avail, make_statics())))
    status = status.cpu().numpy()
    end_bit = 32 * start_w.astype(np.int64) + status[:, 2].astype(np.int64)
    return (out.cpu().numpy().view(np.uint8), status[:, 0], status[:, 1],
            end_bit)
