"""How long the host was blocked on the card in the program's spans, read
by the per-layer metrics ``card_wait_ms_per_MiB.<split>`` and
``card_wait_ms_per_op.range``.

The program's recorder keeps a field ``wait_s`` a span name in its
snapshot beside its times (``deflate_tpu_torch.utils.metrics``): the
seconds the program itself held the host blocked on the card while the
span was the innermost open one, in ``metrics.to_device``'s and
``metrics.to_host``'s copies across and in ``metrics.sync_stream``.  The
recorder's own synchronisations are kept apart (``sync_s``) and are not
read here: an unrecorded run never makes them.  The field sums to the
op's whole, so these readers sum it over every span of the window's ops
(``program.window()``).  Where the recorder keeps no such field (an
older program) or recorded no op, they return None.
"""
from __future__ import annotations

from codecbench import program

RANGE_SPAN = "decode.range_plan"    # opened once by every range read


def per_op(field: str, range_read: bool = False) -> float | None:
    """`field` summed over every span of the window's ops, per op; None
    without it, and with range_read where the ops read no range."""
    snap = program.window()
    if snap is None:
        return None
    spans = snap["spans"]
    if not all(field in v for v in spans.values()):
        return None
    if range_read and RANGE_SPAN not in spans:
        return None
    return sum(v[field] for v in spans.values()) / snap["ops"]


def per_mib(ctx, field: str) -> float | None:
    """per_op(field) over the MiB of an op's chunk (every chunk of a
    pool has one size)."""
    v = per_op(field)
    if v is None:
        return None
    return v / (ctx.work_bytes / len(ctx.ops) / 2 ** 20)
