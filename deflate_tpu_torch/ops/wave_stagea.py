"""Kernel K2, fused wavefront stages A+B and within-chunk compaction, and
kernel K8, stage A alone (both in csrc/wave_stagea.cu, around the
table-driven decode of csrc/stagea_core.cuh).

K2 replaces deflate_tpu/ops/wave_stagea.py (`_kernel_ab`, wrapper
`decode_mark_pallas`).  Plain version: the same composition as the
reference's unfused branch (wave.py:834-849) — decode_positions, the
stop_bit override, chunk_automaton and chunk_compact — with rows at or
past a chunk's symbol count zeroed.  Those rows hold leftovers of the
compaction rounds in the reference; no reader looks at them (stage D
routes only the first sum_cnt rows of each chunk), and zeroing them
makes kernel and plain version equal in every entry.

K8 replaces `_kernel` (wrapper `decode_positions_pallas`): A0/P1 at every
bit position, always 15 compare rounds as the reference's wrapper runs.
Plain version: wave.decode_positions.  decode_mark_split is the
reference's unfused route: K8, then the same torch tail as
decode_mark_plain.

Both kernels decode through per-block tables (build_tables): a litlen
entry for every KL-bit peek and a distance entry for every KD-bit one,
each the result of wave.decode_core's canonical decode and the
arithmetic that follows it, or SLOW where the code is not found within
that many bits but may be in more; a SLOW position runs decode_core
itself.
decode_positions_lut and decode_mark_lut are that design in torch, for
the tests and chip_smoke.py; the CPU dispatch takes the plain versions.
"""
from __future__ import annotations

import torch

from deflate_tpu_torch import _build
from deflate_tpu_torch.ops import wave as W
from deflate_tpu_torch.utils.bits import I32, srl

SUM_KEYS = ("Mlo", "Mhi", "Clo", "Chi", "sum_emit", "sum_cnt",
            "sum_match", "sum_eob", "sum_inv")
KL = 11                      # litlen table index bits (csrc/stagea_core.cuh)
KD = 10                      # distance table index bits
TABLE_WORDS = (1 << KL) + (1 << KD)   # one block's tables, int32
SLOW = -1                    # table entry: decode the position in full
MATCH = -(1 << 31)           # bit 31 of a litlen entry: a match
launches = 0                 # K2
positions_launches = 0       # K8


# ====================== the table-driven decode (torch form) ==============
def _getter(mds, ki, bidx=None):
    """decode_core's g(key, l) over md rows: per block ([B, 1]) or, with
    bidx, per element."""
    if bidx is None:
        B = mds.shape[0]
        return lambda key, l: mds[:, ki[key], l].reshape(B, 1)
    return lambda key, l: mds[bidx, ki[key], l]


def _never_found(idx, g, lim_key: str, lo: int, hi: int):
    """True where no peek that starts with the first lo bits of idx finds
    a code in rounds lo+1 .. hi (canon hits only where c < lim[l], and the
    least c a round l can reach is c_lo << (l - lo))."""
    c = torch.zeros_like(idx)
    for l in range(1, lo + 1):
        c = (c << 1) | (srl(idx, l - 1) & 1)
    never = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    for l in range(lo + 1, hi + 1):
        never = never & ((c << (l - lo)) >= g(lim_key, l))
    return never


def build_tables(mds, kl: int = KL, kd: int = KD, maxl: int = 15,
                 maxd: int = 15):
    """Per-block decode tables: lut int32 [B, 2**kl], dlut int32 [B,
    2**kd].

    lut[b, i] for the peek bits i, decoded with min(kl, maxl) rounds:
      SLOW   where no code is found there but a longer peek may find one
             within maxl rounds;
      >= 0   a literal, EOB or no code within maxl rounds: decode_core's
             A0 itself (P1 = 0);
      < 0    a match (MATCH | len | extra bits << 4 | base length << 7),
             with 1 <= len <= 15; other lengths are SLOW.
    dlut[b, j] for distance bits j, with min(kd, maxd) rounds: SLOW as
    above or where the length is outside 0..15, else len | extra-bit
    shift (clamp(len, 1, 28)) << 4 | extra bits << 8 | base distance <<
    12 | no code << 27."""
    B, dev = mds.shape[0], mds.device
    g = _getter(mds.to(I32), {k: i for i, k in enumerate(W.MD_KEYS)})
    rl, rd = min(kl, maxl), min(kd, maxd)
    i = torch.arange(1 << kl, dtype=I32, device=dev)[None, :].expand(B, -1)
    found, len_, r_rel, is_lit, is_eob, is_m, ebits, lbase = W.lit_fields(
        i, g, rl)
    cls = torch.where(found, 2 * is_eob.to(I32), 3)
    a0 = (torch.clamp(len_, 1, 63) | (is_lit.to(I32) << 6) | (cls << 15)
          | (r_rel << 17) | (len_ << 26))
    lut = torch.where(is_m, MATCH | len_ | (ebits << 4) | (lbase << 7), a0)
    ok = torch.where(is_m, (len_ >= 1) & (len_ <= 15),
                     (found | _never_found(i, g, "l_lim", rl, maxl))
                     & (a0 >= 0))
    lut = torch.where(ok, lut, SLOW)
    j = torch.arange(1 << kd, dtype=I32, device=dev)[None, :].expand(B, -1)
    dfound, dlen, debits, dbase = W.dist_fields(j, g, rd)
    ok = ((dfound | _never_found(j, g, "d_lim", rd, maxd))
          & (dlen >= 0) & (dlen <= 15))
    dlut = torch.where(ok, dlen | (torch.clamp(dlen, 1, 28) << 4)
                       | (debits << 8) | (dbase << 12)
                       | ((~dfound).to(I32) << 27), SLOW)
    return lut.to(I32), dlut.to(I32)


def _gather(table, idx):
    """table[b, idx[b, ...]] for int32 [B, ...] indices."""
    B = idx.shape[0]
    return torch.gather(table, 1, idx.reshape(B, -1).long()).reshape(
        idx.shape)


def decode_lut(PK, PKH, mds, lut, dlut, maxl: int = 15, maxd: int = 15):
    """decode_core by the tables: (A0, P1), each of PK's shape [B, ...].
    A position whose litlen entry, or a match's distance entry, is SLOW
    runs decode_core itself with maxl / maxd rounds."""
    kl = lut.shape[1].bit_length() - 1
    kd = dlut.shape[1].bit_length() - 1
    e = _gather(lut, PK & ((1 << kl) - 1))
    ln = e & 15
    eb = srl(e, 4) & 7
    length = (srl(e, 7) & 511) + (srl(PK, ln) & ((1 << eb) - 1))
    adv1 = ln + eb
    pk2 = srl(PK, adv1) | (PKH << (32 - adv1))
    d = _gather(dlut, pk2 & ((1 << kd) - 1))
    dlen = d & 15
    deb = srl(d, 8) & 15
    dist = (srl(d, 12) & 0x7FFF) + (srl(pk2, srl(d, 4) & 15)
                                    & ((1 << deb) - 1))
    a0m = ((adv1 + dlen + deb) | (length << 6)
           | ((1 + 2 * (srl(d, 27) & 1)) << 15)
           | (torch.clamp(length - 3, 0, 255) << 17) | (ln << 26))
    A0 = torch.where(e >= 0, e, a0m)
    P1 = torch.where(e >= 0, 0, dist)
    slow = (e == SLOW) | ((e < 0) & (d == SLOW))
    if bool(slow.any()):
        bidx = torch.nonzero(slow)[:, 0]
        g = _getter(mds.to(I32), {k: i for i, k in enumerate(W.MD_KEYS)},
                    bidx)
        A0[slow], P1[slow] = W.decode_core(PK[slow], PKH[slow], g, maxl,
                                           maxd)
    return A0.to(I32), P1.to(I32)


def decode_positions_lut(nwords, mds, W64: int, kl: int = KL,
                         kd: int = KD):
    """K8's design in torch: stage A at every bit position through the
    tables, 15 rounds.  Same contract as decode_positions_plain."""
    PK, PKH = W.build_peeks(nwords, W64)
    lut, dlut = build_tables(mds, kl, kd)
    return decode_lut(PK, PKH, mds, lut, dlut)


def decode_mark_lut(nwords, hints, mds, W64: int, stop_bit=None,
                    maxl: int = 15, maxd: int = 15, kl: int = KL,
                    kd: int = KD):
    """K2's design in torch: every chunk walks its chain of symbol starts
    from its hint, one step per round for all chunks at once, decoding
    through the tables; same contract as decode_mark_plain."""
    B, dev = nwords.shape[0], nwords.device
    lut, dlut = build_tables(mds, kl, kd, maxl, maxd)
    x0, x1, x2, x3 = (nwords[:, k:2 * W64 + k:2] for k in range(4))
    h = hints.to(I32)
    z = torch.zeros((B, W64), dtype=I32, device=dev)
    t = torch.where(h < 32, torch.clamp(h, 0, 31),
                    torch.where(h < 64, h, 64))
    Mlo = torch.where(h < 32, 1 << torch.clamp(h, 0, 31), 0)
    Mhi = torch.where((h >= 32) & (h < 64), 1 << torch.clamp(h - 32, 0, 31),
                      0)
    marks = [Mlo, Mhi, z, z]               # Mlo, Mhi, Clo, Chi
    se = sc = sm = sb = si = z
    A0c = torch.zeros((B, W.CCAP, W64), dtype=I32, device=dev)
    P1c = torch.zeros_like(A0c)
    rank = torch.arange(W.CCAP, dtype=I32, device=dev)[None, :, None]
    pos = torch.arange(W64, dtype=I32, device=dev)[None, :] * 64
    live = t < 64
    while bool(live.any()):
        hi = t >= 32
        r = t & 31
        a = torch.where(hi, x1, x0)
        b = torch.where(hi, x2, x1)
        c = torch.where(hi, x3, x2)
        PK = torch.where(r == 0, a, srl(a, r) | (b << (32 - r)))
        PKH = torch.where(r == 0, b, srl(b, r) | (c << (32 - r)))
        A0, P1 = decode_lut(PK, PKH, mds, lut, dlut, maxl, maxd)
        if stop_bit is not None:
            A0 = torch.where(pos + t == stop_bit.to(I32)[:, None],
                             1 | (2 << 15), A0)
        put = (rank == sc[:, None, :]) & live[:, None, :]
        A0c = torch.where(put, A0[:, None, :], A0c)
        P1c = torch.where(put, P1[:, None, :], P1c)
        cls = srl(A0, 15) & 3
        li = live.to(I32)
        se = se + li * (srl(A0, 6) & 511)
        sc = sc + li
        sm = sm + li * (cls == 1).to(I32)
        sb = sb + li * (cls == 2).to(I32)
        si = si + li * (cls == 3).to(I32)
        go = live & (cls < 2)
        nt = t + (A0 & 63)
        for k in range(4):                 # nt's bit in marks[nt // 32]
            marks[k] = marks[k] | torch.where(
                go & (nt >= 32 * k) & (nt < 32 * k + 32),
                1 << torch.clamp(nt - 32 * k, 0, 31), 0)
        t = torch.where(go, nt, t)
        live = go & (nt < 64)
    sums = torch.stack(marks + [se, sc, sm, sb, si], 1)
    return A0c, P1c, sums.to(I32)


# ====================== plain versions and kernels ========================
def _mark_from(stage_a, nwords, hints, mds, W64: int, stop_bit, maxl: int,
               maxd: int):
    """Stage A by stage_a(nwords, mds, W64, maxl, maxd) -> (A0, P1), then
    the stop_bit override, chunk_automaton and chunk_compact in torch,
    with rows at or past each chunk's count zeroed.  Returns (A0c, P1c
    int32 [B, CCAP, W64], sums int32 [B, 9, W64])."""
    A0, P1 = stage_a(nwords, mds, W64, maxl, maxd)
    if stop_bit is not None:
        dev = nwords.device
        pos = (torch.arange(W64, dtype=I32, device=dev)[None, None, :] * 64
               + torch.arange(64, dtype=I32, device=dev)[None, :, None])
        A0 = torch.where(pos == stop_bit.to(I32)[:, None, None],
                         1 | (2 << 15), A0)
    sums, rank_rows = W.chunk_automaton(A0, hints, W64)
    mk = W._unpack_marks(sums["Mlo"], sums["Mhi"], W64) > 0
    A0c, P1c = W.chunk_compact(A0, P1, rank_rows, mk)
    rows = (torch.arange(W.CCAP, dtype=I32, device=nwords.device)
            [None, :, None] < sums["sum_cnt"][:, None, :])
    return (torch.where(rows, A0c, 0), torch.where(rows, P1c, 0),
            torch.stack([sums[k] for k in SUM_KEYS], 1))


def decode_mark_plain(nwords, hints, mds, W64: int, stop_bit=None,
                      maxl: int = 15, maxd: int = 15):
    """Returns (A0c, P1c int32 [B, CCAP, W64], sums int32 [B, 9, W64])."""
    return _mark_from(W.decode_positions, nwords, hints, mds, W64,
                      stop_bit, maxl, maxd)


def mark_launch(nwords, hints, mds, stop, a0c, p1c, sums, tables, W64: int,
                maxl: int, maxd: int) -> None:
    """dt_decode_mark alone on checked operands (stop int32 [B] or None),
    into preallocated outputs and table scratch [B, TABLE_WORDS]."""
    err = _build.lib("wave_stagea").dt_decode_mark(
        nwords.data_ptr(), hints.data_ptr(), mds.data_ptr(),
        None if stop is None else stop.data_ptr(), tables.data_ptr(),
        a0c.data_ptr(), p1c.data_ptr(), sums.data_ptr(), nwords.shape[0],
        W64, maxl, maxd, TABLE_WORDS, _build.stream_ptr(nwords.device))
    _build.check(err, "dt_decode_mark")


def decode_mark_kernel(nwords, hints, mds, W64: int, stop_bit=None,
                       maxl: int = 15, maxd: int = 15):
    """K2 on the card: same contract as decode_mark_plain."""
    global launches
    nwords = nwords.to(I32).contiguous()
    hints = hints.to(I32).contiguous()
    mds = mds.to(I32).contiguous()
    stop = None if stop_bit is None else stop_bit.to(I32).contiguous()
    dev = _build.require_cuda(nwords, hints, mds,
                              *(() if stop is None else (stop,)))
    B = nwords.shape[0]
    if nwords.shape != (B, 2 * W64 + 4) or hints.shape != (B, W64) \
            or mds.shape != (B, 7, 16) \
            or (stop is not None and stop.shape != (B,)):
        raise ValueError(f"bad stage-A operands {tuple(nwords.shape)}, "
                         f"{tuple(hints.shape)}, {tuple(mds.shape)} for "
                         f"W64={W64}")
    if not (1 <= maxl <= 15 and 1 <= maxd <= 15):
        raise ValueError(f"maxl/maxd out of range: {maxl}, {maxd}")
    # one allocation (host time sets this call's cost): the tables
    # scratch first, 16-byte aligned, then the outputs
    rows = B * W.CCAP * W64
    tables, A0c, P1c, sums = torch.empty(
        B * TABLE_WORDS + 2 * rows + B * len(SUM_KEYS) * W64, dtype=I32,
        device=dev).split([B * TABLE_WORDS, rows, rows,
                           B * len(SUM_KEYS) * W64])
    A0c = A0c.view(B, W.CCAP, W64)
    P1c = P1c.view(B, W.CCAP, W64)
    sums = sums.view(B, len(SUM_KEYS), W64)
    if B:
        mark_launch(nwords, hints, mds, stop, A0c, P1c, sums, tables, W64,
                    maxl, maxd)
        launches += 1
    return A0c, P1c, sums


def _sums_dict(A0c, P1c, sums):
    return A0c, P1c, {k: sums[:, i] for i, k in enumerate(SUM_KEYS)}


def decode_mark(nwords, hints, mds, W64: int, stop_bit=None,
                maxl: int = 15, maxd: int = 15):
    """Fused stage A+B+compaction for one bucket.

    nwords int32 [B, 2*W64+4]; hints int32 [B, W64]; mds int32 [B, 7, 16]
    (wave.stack_md); stop_bit int32 [B] or None.  Returns (A0c, P1c
    [B, CCAP, W64] — chunk w's rank-j symbol at [b, j, w], zero past
    the chunk's count — and sums dict of [B, W64]).  CUDA tensors run
    K2; CPU tensors the plain version."""
    fn = decode_mark_kernel if nwords.is_cuda else decode_mark_plain
    return _sums_dict(*fn(nwords, hints, mds, W64, stop_bit, maxl, maxd))


def decode_positions_plain(nwords, mds, W64: int):
    """A0, P1 int32 [B, 64, W64] at 15 compare rounds."""
    return W.decode_positions(nwords, mds, W64)


def decode_positions_kernel(nwords, mds, W64: int):
    """K8 on the card: same contract as decode_positions_plain."""
    global positions_launches
    nwords = nwords.to(I32).contiguous()
    md7 = mds[:, :len(W.MD_KEYS)].to(I32).contiguous()
    dev = _build.require_cuda(nwords, md7)
    B = nwords.shape[0]
    if nwords.shape != (B, 2 * W64 + 4) or md7.shape != (B, 7, 16):
        raise ValueError(f"bad stage-A operands {tuple(nwords.shape)}, "
                         f"{tuple(md7.shape)} for W64={W64}")
    # one allocation: the tables scratch first, 16-byte aligned
    n = B * 64 * W64
    tables, A0, P1 = torch.empty(B * TABLE_WORDS + 2 * n, dtype=I32,
                                 device=dev).split([B * TABLE_WORDS, n, n])
    A0 = A0.view(B, 64, W64)
    P1 = P1.view(B, 64, W64)
    if B:
        err = _build.lib("wave_stagea").dt_decode_positions(
            nwords.data_ptr(), md7.data_ptr(), tables.data_ptr(),
            A0.data_ptr(), P1.data_ptr(), B, W64, TABLE_WORDS,
            _build.stream_ptr(dev))
        _build.check(err, "dt_decode_positions")
        positions_launches += 1
    return A0, P1


def decode_positions(nwords, mds, W64: int):
    """Stage A at every bit position: A0, P1 int32 [B, 64, W64] (A0[b, t,
    w] decodes body bit 64w + t).  CUDA tensors run K8; CPU tensors the
    plain version."""
    fn = decode_positions_kernel if nwords.is_cuda else \
        decode_positions_plain
    return fn(nwords, mds, W64)


def decode_mark_split(nwords, hints, mds, W64: int, stop_bit=None,
                      maxl: int = 15, maxd: int = 15):
    """decode_mark by the unfused route: stage A on K8 (15 rounds; maxl
    and maxd are ignored, as the reference's wrapper ignores them), then
    the stop override, mark automaton and compaction in torch."""
    def stage_a(nw, m, w64, _maxl, _maxd):
        return decode_positions(nw, m, w64)

    return _sums_dict(*_mark_from(stage_a, nwords, hints, mds, W64,
                                  stop_bit, maxl, maxd))
