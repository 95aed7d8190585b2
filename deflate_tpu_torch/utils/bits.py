"""int32 bit helpers with XLA's shift semantics.

torch's ``>>`` on int32 is arithmetic and CPU builds have no shifts on
uint32, while the reference leans on ``jax.lax.shift_right_logical``.
Every logical shift of the port goes through :func:`srl`; ``<<`` on int32
wraps in torch as in XLA (shift counts >= 32 give 0 on both, on the CPU
and on CUDA).
"""
from __future__ import annotations

import torch

I32 = torch.int32
I64 = torch.int64
M32 = 0xFFFFFFFF


def srl(x: torch.Tensor, n) -> torch.Tensor:
    """Logical right shift of int32 ``x`` by ``n`` (int or int32 tensor);
    counts >= 32 give 0, as in XLA."""
    if isinstance(n, int):
        if n == 0:
            return x
        if n >= 32:
            return torch.zeros_like(x)
        return (x >> n) & ((1 << (32 - n)) - 1)
    # torch gives 0 for int32 shifts by >= 32, so the mask is -1 at n = 0
    # and 0 at n = 32; counts outside [0, 32] act as 32 (XLA: result 0)
    n = torch.where((n < 0) | (n > 32), 32, n).to(x.dtype)
    return (x >> n) & ((1 << (32 - n)) - 1)


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit pattern (any sign) -> int32 with that
    pattern."""
    x = x & M32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(I32)


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 -> int64 holding the unsigned 32-bit value."""
    return x.to(I64) & M32


def exclusive(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exclusive prefix sum in a's dtype (int32 wraps like XLA's)."""
    return (torch.cumsum(a, dim=dim) - a).to(a.dtype)
