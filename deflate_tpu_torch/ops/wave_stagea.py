"""Kernel K2: fused wavefront stages A+B and within-chunk compaction
(csrc/wave_stagea.cu).

Replaces deflate_tpu/ops/wave_stagea.py (`_kernel_ab`, wrapper
`decode_mark_pallas`).  Plain version: the same composition as the
reference's unfused branch (wave.py:834-849) — decode_positions, the
stop_bit override, chunk_automaton and chunk_compact — with rows at or
past a chunk's symbol count zeroed.  Those rows hold leftovers of the
compaction rounds in the reference; no reader looks at them (stage D
routes only the first sum_cnt rows of each chunk), and zeroing them
makes kernel and plain version equal in every entry.
"""
from __future__ import annotations

import torch

from deflate_tpu_torch import _build
from deflate_tpu_torch.ops import wave as W
from deflate_tpu_torch.utils.bits import I32

SUM_KEYS = ("Mlo", "Mhi", "Clo", "Chi", "sum_emit", "sum_cnt",
            "sum_match", "sum_eob", "sum_inv")
launches = 0


def _md8(mds: torch.Tensor, stop_bit) -> torch.Tensor:
    """md tables [B, 7, 16] plus the stop bit in row 7, column 0."""
    B = mds.shape[0]
    srow = torch.zeros((B, 1, 16), dtype=I32, device=mds.device)
    if stop_bit is not None:
        srow[:, 0, 0] = stop_bit.to(I32)
    else:
        srow[:, 0, 0] = -1
    return torch.cat([mds.to(I32), srow], 1).contiguous()


def decode_mark_plain(nwords, hints, mds, W64: int, stop_bit=None,
                      maxl: int = 15, maxd: int = 15):
    """Returns (A0c, P1c int32 [B, CCAP, W64], sums int32 [B, 9, W64])."""
    A0, P1 = W.decode_positions(nwords, mds, W64, maxl, maxd)
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


def decode_mark_kernel(nwords, hints, mds, W64: int, stop_bit=None,
                       maxl: int = 15, maxd: int = 15):
    """K2 on the card: same contract as decode_mark_plain."""
    global launches
    nwords = nwords.to(I32).contiguous()
    hints = hints.to(I32).contiguous()
    md8 = _md8(mds, stop_bit)
    dev = _build.require_cuda(nwords, hints, md8)
    B = nwords.shape[0]
    if nwords.shape != (B, 2 * W64 + 4) or hints.shape != (B, W64):
        raise ValueError(f"bad stage-A operands {tuple(nwords.shape)}, "
                         f"{tuple(hints.shape)} for W64={W64}")
    if not (1 <= maxl <= 15 and 1 <= maxd <= 15):
        raise ValueError(f"maxl/maxd out of range: {maxl}, {maxd}")
    A0c = torch.empty((B, W.CCAP, W64), dtype=I32, device=dev)
    P1c = torch.empty_like(A0c)
    sums = torch.empty((B, len(SUM_KEYS), W64), dtype=I32, device=dev)
    if B:
        err = _build.lib("wave_stagea").dt_decode_mark(
            nwords.data_ptr(), hints.data_ptr(), md8.data_ptr(),
            A0c.data_ptr(), P1c.data_ptr(), sums.data_ptr(),
            B, W64, maxl, maxd, _build.stream_ptr(dev))
        _build.check(err, "dt_decode_mark")
        launches += 1
    return A0c, P1c, sums


def decode_mark(nwords, hints, mds, W64: int, stop_bit=None,
                maxl: int = 15, maxd: int = 15):
    """Fused stage A+B+compaction for one bucket.

    nwords int32 [B, 2*W64+4]; hints int32 [B, W64]; mds int32 [B, 7, 16]
    (wave.stack_md); stop_bit int32 [B] or None.  Returns (A0c, P1c
    [B, CCAP, W64] — chunk w's rank-j symbol at [b, j, w], zero past
    the chunk's count — and sums dict of [B, W64]).  CUDA tensors run
    K2; CPU tensors the plain version."""
    fn = decode_mark_kernel if nwords.is_cuda else decode_mark_plain
    A0c, P1c, sums = fn(nwords, hints, mds, W64, stop_bit, maxl, maxd)
    return A0c, P1c, {k: sums[:, i] for i, k in enumerate(SUM_KEYS)}
