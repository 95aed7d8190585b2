"""Kernel K3: stable monotone routing, one 1024-slot tile per CTA
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

MAXP = 3                     # payloads per call
TILE = 1024                  # slots per CTA (csrc/wave_route.cu)
launches = 0
_dt_route = None             # the loaded entry point


def route_plain(payloads, delta, rounds: int, left: bool = True):
    fn = W.route_monotone_left if left else W.route_monotone_right
    pays, dout = fn(list(payloads), delta, rounds)
    landed = dout == 0
    return ([torch.where(landed, p, 0) for p in pays],
            torch.where(landed, 0, -1).to(I32))


def launch(payloads, delta, out_ptrs, dout_ptr, last_ptr, rounds: int,
           left: bool):
    """One dt_route call on operands route_kernel has checked, into
    outputs at the given device addresses (P payload planes and dout,
    each [B, L] contiguous, and B * ceil(L / TILE) words of scratch);
    counts nothing (timing runs call it directly)."""
    global _dt_route
    if _dt_route is None:
        _dt_route = _build.lib("wave_route").dt_route
    B, L = delta.shape
    pad = [0] * (MAXP - len(payloads))
    err = _dt_route(*[p.data_ptr() for p in payloads], *pad,
                    *[p.stride(0) for p in payloads], *pad,
                    delta.data_ptr(), *out_ptrs, *pad, dout_ptr, last_ptr,
                    len(payloads), B, L, rounds, int(left),
                    _build.stream_ptr(delta.device))
    _build.check(err, "dt_route")


def route_kernel(payloads, delta, rounds: int, left: bool = True):
    """K3 on the card: same contract as route_plain.  Payloads are int32
    [B, L] rows with unit column stride (any row stride); delta is
    contiguous int32 [B, L].  One allocation holds the P outputs, dout
    and the kernel's scratch; the outputs and dout are views of it."""
    global launches
    dev = delta.device
    B, L = delta.shape
    P = len(payloads)
    if not (delta.is_cuda and delta.dtype == I32 and delta.is_contiguous()
            and 1 <= P <= MAXP and 0 <= rounds <= 31):
        raise ValueError(f"route takes contiguous int32 CUDA delta, 1-{MAXP} "
                         f"payloads and 0-31 rounds; got {delta.dtype} on "
                         f"{dev}, {P} payloads, rounds={rounds}")
    for p in payloads:
        if p.device != dev or p.dtype != I32 or p.shape != delta.shape \
                or (L > 1 and p.stride(1) != 1):
            raise ValueError(f"route payload {p.dtype} {tuple(p.shape)} "
                             f"on {p.device} does not match delta "
                             f"{(B, L)} on {dev} with unit column stride")
    n = (P + 1) * B * L
    buf = torch.empty(n + B * -(-L // TILE), dtype=I32, device=dev)
    *outs, dout = buf[:n].view(P + 1, B, L).unbind(0)
    if n:
        base, plane = buf.data_ptr(), 4 * B * L
        launch(payloads, delta, [base + k * plane for k in range(P)],
               base + P * plane, base + 4 * n, rounds, left)
        launches += 1
    return outs, dout


def route(payloads, delta, rounds: int, left: bool = True):
    """Move each occupied slot's payloads (list of int32 [B, L]) by
    delta int32 [B, L] (< 0: empty).  Returns (payloads, dout).  CUDA
    tensors run K3; CPU tensors the plain version."""
    fn = route_kernel if delta.is_cuda else route_plain
    return fn(payloads, delta, rounds, left)
