"""deflate_tpu_torch — the DEFLATE codec in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of ``deflate_tpu`` (JAX/Pallas), held bit-for-bit against it.  This
package imports ``torch`` and never ``jax`` or ``deflate_tpu``.

Manifest path (level-2 encode, then device decode):

    from deflate_tpu_torch.runtime import manifest as M
    stream, man = M.compress_with_manifest(data, level=2)
    out = M.decode_all(stream, man)

Bare raw and zlib streams, from any encoder:

    out = deflate_tpu_torch.decompress(raw, force_device=True)
    out = deflate_tpu_torch.decompress_zlib(zdata, force_device=True)

Without force_device, ``decompress`` and ``decompress_zlib`` decode a
bare stream on the HOST even when a device is named (the reference's
policy; the card is still required to be present): force_device=True is
the only way onto the card for them.
``device`` is a torch device and defaults to the card ("cuda"); without
one the entry points raise rather than run on the CPU.  device="cpu" runs
the same torch path with every kernel's plain PyTorch version (the tests
do); device=None in ``decompress``, ``decompress_zlib`` and
``decode_all`` is the host decoder (the reference's device=False).  On a
CUDA device every kernel of a path (ops/tree.py, ops/wave_stagea.py,
ops/wave_route.py, ops/wave_fill.py, ops/block_inflate.py) launches its
CUDA C++ kernel from ``csrc/``, built by ``_build.py`` at first use.  A
forced stream that neither the wavefront decoder nor K6 serves goes to
the speculative decoder (models/decoder.py): torch array code on the
same device, as the reference's decoder there is plain XLA.
"""
from __future__ import annotations

from deflate_tpu_torch.models import host_inflate as _hi

InflateError = _hi.InflateError

__all__ = ["decompress", "decompress_zlib", "InflateError"]


def decompress(data, out_size: int | None = None, device="cuda",
               stats: dict | None = None,
               force_device: bool = False) -> bytes:
    """Decompress a raw DEFLATE stream.

    Called with its defaults this decodes on the HOST: for a bare stream
    (no manifest hints) a device routes to the host decoder unless
    force_device=True, because the device path first needs a full
    sequential host walk (the skeleton plan).  The named device must
    still exist.  force_device=True is the only way onto the card; the
    stream decodes on `device` through the skeleton walk and the
    wavefront decoder (kernels K2, K3, K5, or K4 for self-contained
    plans), else through kernel K6 block by block, else through the
    speculative decoder (models/decoder.py, torch array code), which
    takes out_size only as a hint and falls back to the host decoder
    when it flags the stream.  device=None is the host decoder.  stats:
    an empty dict that receives a run report, including which decoder
    served (``device_path``: "wave", "pallas_scalar", "speculative",
    "native_host") and ``redirected``.
    """
    if device is not None:
        from deflate_tpu_torch._build import torch_device

        torch_device(device)
    if stats is not None:
        import time as _time

        t0 = _time.perf_counter()
        path = {}
        out = _decompress_impl(bytes(data), out_size, device, path,
                               force_device)
        dt = _time.perf_counter() - t0
        stats.update({
            "op": "decompress", "bytes_in": len(data),
            "bytes_out": len(out), "seconds": round(dt, 4),
            "mb_per_s": round(len(out) / dt / 1e6, 2) if dt else None,
            "device": None if device is None else str(device),
            "device_path": path.get("path"),
            "redirected": path.get("redirected")})
        return out
    return _decompress_impl(bytes(data), out_size, device, None,
                            force_device)


def _decompress_impl(raw: bytes, out_size, device, path: dict | None,
                     force_device: bool = False) -> bytes:
    """Decode dispatcher (the reference's).  Records which backend served
    the call in path["path"].  A kernel's build or launch error
    propagates; the next decoder is tried only where a path declines the
    stream (no plan, a window past the largest bucket, a flagged block,
    another output size, PallasDecodeError).  The last device decoder,
    the speculative one, ends in the host decoder itself."""
    def _mark(p):
        if path is not None:
            path["path"] = p

    if device is not None and not force_device:
        device = None
        if path is not None:
            path["redirected"] = "device_to_host_default"
    if device is not None:
        from deflate_tpu_torch.models import block_decoder as _bd

        wave_out = _try_wave_decompress(raw, out_size, device)
        if wave_out is not None:
            _mark("wave")
            return wave_out
        try:
            # K6: any stream whose blocks are self-contained (always
            # true for this package's encoder output, quirk Q5)
            out = _bd.inflate_stream(raw, device=device)
            _mark("pallas_scalar")
            return out
        except _bd.PallasDecodeError:
            pass
        from deflate_tpu_torch.models import decoder as _dd

        _mark("speculative")
        return _dd.inflate_device(raw, out_size, device=device)
    from deflate_tpu_torch import native as _nat

    try:
        out = _nat.inflate(raw, out_size or max(1024, 8 * len(raw)),
                           exact=out_size is not None)
    except ValueError as e:
        raise InflateError(str(e)) from None
    _mark("native_host")
    return out


def _try_wave_decompress(raw: bytes, out_size, device) -> bytes | None:
    """Wavefront path for a bare stream: the native skeleton walk derives
    every virtual block's bit offset, output size and per-chunk hints,
    then the wavefront decoder decodes them on `device`.  Returns None
    when the walk or the decoder declines the stream."""
    from deflate_tpu_torch.models import wave_decoder as _wd

    plan = _wd.skeleton_plan(raw)
    if plan is None:
        return None
    out, err = _wd.inflate_wave_planned(raw, plan, device=device)
    if out is None or err.any():
        return None
    if out_size is not None and len(out) != out_size:
        return None
    return out


def decompress_zlib(data, device="cuda", force_device: bool = False) -> bytes:
    """Decompress a zlib-wrapped (RFC 1950) stream, verifying Adler-32.
    device=None decodes on the host; otherwise the payload goes through
    ``decompress``: on the card with force_device=True, else redirected
    to the host."""
    data = bytes(data)
    if device is None:
        return _hi.inflate_zlib(data)
    payload, stored = _hi.zlib_unwrap(data)
    return _hi.check_adler32(
        decompress(payload, device=device, force_device=force_device),
        stored)
