"""The program's own spans and counters, read by the per-layer metrics
``self_ms_per_MiB.<split>`` and ``copies_per_op.<split>``.

The port records them itself (``deflate_tpu_torch.utils.metrics``): spans
at the layer boundaries of its encode and decode paths, on the clock the
profiler stamps host events with, and counters of host-device copies,
kernel launches and the decoder that served.  Importing this module in a
process with a card switches that recorder on, with spans that
synchronise the card at their ends (not under a profiler), as the
harness's timed spans do.  The harness loads a cell's per-layer readers,
and so this module, before the window only in a traced run (to collect
their SPANS), so the recorder runs in the traced window and in the
profiled slice after it, never in a ``--trace 0`` run.  The recorder
keeps the ops that ran under the profiler apart; these readers read the
window's ops alone.  Where the program has no recorder, every reader
returns None.
"""
from __future__ import annotations

# self_ms_per_MiB.<split>: the summed self time of these spans (a name
# ending in "." is a prefix)
SELF_SPANS = {
    "lz77": ("lz77.",),
    "encode_emit": ("encode.trees", "encode.choose", "encode.emit",
                    "encode.hints"),
    "encode_to_host": ("encode.split", "encode.to_host"),
    "decode_prep": ("decode.skeleton", "decode.headers", "decode.windows"),
    "wave_glue": ("wave.",),
    "decode_transfer": ("decode.to_device", "decode.to_host"),
}
COPIES = ("copy.h2d", "copy.d2h")


def recorder():
    """The program's recorder module, or None where it has none."""
    try:
        from deflate_tpu_torch.utils import metrics
    except ImportError:
        return None
    if not all(hasattr(metrics, f) for f in ("start", "snapshot", "span")):
        return None
    return metrics


def _switch_on() -> None:
    import torch

    m = recorder()
    if m is not None and torch.cuda.is_available():
        m.start(sync=True)


def window() -> dict | None:
    """The recorder's snapshot of the ops that ran with no profiler, or
    None when it recorded none."""
    m = recorder()
    if m is None:
        return None
    snap = m.snapshot(profiled=False)
    return snap if snap["ops"] else None


def matches(name: str, names) -> bool:
    return any(name.startswith(n) if n.endswith(".") else name == n
               for n in names)


def self_ms_per_mib(ctx, split: str) -> float | None:
    """ms of self time of the split's spans per MiB of the ops' chunks
    (every chunk of a pool has one size)."""
    snap = window()
    if snap is None:
        return None
    got = [v["self_s"] for k, v in snap["spans"].items()
           if matches(k, SELF_SPANS[split])]
    if not got:
        return None
    mib_per_op = ctx.work_bytes / len(ctx.ops) / 2 ** 20
    return 1e3 * sum(got) / snap["ops"] / mib_per_op


def copies_per_op(ctx) -> float | None:
    """Host-to-device and device-to-host copies counted per op."""
    snap = window()
    if snap is None:
        return None
    return sum(snap["counts"].get(k, 0) for k in COPIES) / snap["ops"]


_switch_on()
