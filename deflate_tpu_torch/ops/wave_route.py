"""Kernel K3: stable monotone routing as a direct scatter
(csrc/wave_route.cu).

Replaces deflate_tpu/ops/wave_route.py (`_mk_kernel`, wrapper
`route_pallas`).  Plain version: wave.route_monotone_left/right.

Contract (what every caller reads): an element at slot i with
0 <= delta[i] < 2**rounds lands at i - delta[i] (left) or i + delta[i]
(right) when that slot is in range; the output holds its payloads there
and dout == 0.  Every other slot has payload 0 and dout == -1 — the
plain version's leftovers are cleared to the same values, so kernel and
plain version agree in every entry on valid (monotone) inputs.
"""
from __future__ import annotations

import torch

from deflate_tpu_torch import _build
from deflate_tpu_torch.ops import wave as W
from deflate_tpu_torch.utils.bits import I32

launches = 0


def route_plain(payloads, delta, rounds: int, left: bool = True):
    fn = W.route_monotone_left if left else W.route_monotone_right
    pays, dout = fn(list(payloads), delta, rounds)
    landed = dout == 0
    return ([torch.where(landed, p, 0) for p in pays],
            torch.where(landed, 0, -1).to(I32))


def route_kernel(payloads, delta, rounds: int, left: bool = True):
    """K3 on the card: same contract as route_plain."""
    global launches
    pays = torch.stack([p.to(I32) for p in payloads]).contiguous()
    delta = delta.to(I32).contiguous()
    dev = _build.require_cuda(pays, delta)
    B, L = delta.shape
    P = pays.shape[0]
    if pays.shape[1:] != (B, L) or not 0 <= rounds <= 31:
        raise ValueError(f"bad route operands {tuple(pays.shape)} vs "
                         f"{(B, L)}, rounds={rounds}")
    out = torch.zeros_like(pays)
    dout = torch.full((B, L), -1, dtype=I32, device=dev)
    if B and L:
        err = _build.lib("wave_route").dt_route(
            pays.data_ptr(), delta.data_ptr(), out.data_ptr(),
            dout.data_ptr(), P, B, L, rounds, int(left),
            _build.stream_ptr(dev))
        _build.check(err, "dt_route")
        launches += 1
    return list(out.unbind(0)), dout


def route(payloads, delta, rounds: int, left: bool = True):
    """Move each occupied slot's payloads (list of int32 [B, L]) by
    delta int32 [B, L] (< 0: empty).  Returns (payloads, dout).  CUDA
    tensors run K3; CPU tensors the plain version."""
    fn = route_kernel if delta.is_cuda else route_plain
    return fn(payloads, delta, rounds, left)
