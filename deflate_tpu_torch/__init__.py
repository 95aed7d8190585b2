"""deflate_tpu_torch — the DEFLATE codec in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of ``deflate_tpu`` (JAX/Pallas), held bit-for-bit against it, with
the same public API.  This package imports ``torch`` and never ``jax`` or
``deflate_tpu``.

    compress(data, level=2) -> bytes          # raw DEFLATE
    compress_zlib(data) / compress_gzip(data) # RFC 1950 / 1952 containers
    compress_many(buffers) -> [bytes]         # one batch, one stream each
    compress_file(src, dst, level=2)          # streaming, bounded memory
    decompress(data, out_size=None) -> bytes  # raw DEFLATE
    decompress_zlib(data) / decompress_gzip(data)
    decompress_many(streams) / decompress_file(src, dst)

Levels: 0 stored, 1 Huffman-only, 2 fast (hash-chain), 3 best (lazy).
``compress`` takes backend "device" (the torch encoder, kernel K1 for the
Huffman trees on the card; the default), "native" (the C++ host encoder,
native/deflate.cpp) or "auto" (native below one 32 KiB block).

Manifest path (level-2 encode, then device decode):

    from deflate_tpu_torch.runtime import manifest as M
    stream, man = M.compress_with_manifest(data, level=2)
    out = M.decode_all(stream, man)
    part = M.decode_range(stream, man, start, end)

Bare raw and zlib streams, from any encoder:

    out = deflate_tpu_torch.decompress(raw, force_device=True)
    out = deflate_tpu_torch.decompress_zlib(zdata, force_device=True)

Without force_device, ``decompress`` and ``decompress_zlib`` decode a
bare stream on the HOST even when a device is named (the reference's
policy; the card is still required to be present): force_device=True is
the only way onto the card for them.  ``decompress_gzip``,
``decompress_file`` and ``decode_range`` are host decoders, as in the
reference.
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

import numpy as np

from deflate_tpu_torch.models import host_inflate as _hi
from deflate_tpu_torch.runtime import stitch as _stitch
from deflate_tpu_torch.runtime.manifest import _as_u8, split_blocks
from deflate_tpu_torch.utils.config import CodecConfig
from deflate_tpu_torch.utils.tables import BLOCK_SIZE

InflateError = _hi.InflateError

__all__ = ["compress", "compress_file", "decompress", "decompress_zlib",
           "decompress_file", "compress_zlib", "compress_gzip",
           "decompress_gzip", "compress_many", "decompress_many",
           "InflateError", "CodecConfig"]

SEGMENT_BLOCKS = 64             # blocks a device encode batch holds at most


def _check_level(level: int) -> None:
    if not 0 <= level <= 3:
        raise ValueError(f"level must be 0..3, got {level}")


def _encode_segments(buf: np.ndarray, level: int, dev, phase: int = 0,
                     final: bool = True) -> list:
    """Encode buf's blocks on dev in segments of at most SEGMENT_BLOCKS
    blocks, the stream's bit phase carried from one segment to the next.
    phase: the bit phase buf's first block starts at; final: buf ends
    the stream (its last block carries BFINAL).  Returns [(words int32,
    bits)], one pair a segment, for stitch_segments."""
    import torch

    from deflate_tpu_torch.models import encoder as E

    blocks, blens = split_blocks(buf)
    n = len(blens)
    segments = []
    for lo in range(0, n, SEGMENT_BLOCKS):
        hi = min(n, lo + SEGMENT_BLOCKS)
        words, total = E.encode_batch(
            torch.from_numpy(blocks[lo:hi]).to(dev),
            torch.from_numpy(blens[lo:hi]).to(dev),
            torch.ones(hi - lo, dtype=torch.bool, device=dev),
            hi - lo - 1 if final and hi == n else -1, level, phase)
        total = int(total)
        segments.append((words.cpu().numpy(), total))
        phase = (phase + total) & 7
    return segments


def _zlib_wrap(raw: bytes, buf: np.ndarray) -> bytes:
    """raw in a zlib (RFC 1950) container: header 0x7801 (CM 8, CINFO 7),
    the stream, the Adler-32 of buf."""
    from deflate_tpu_torch import native

    return (bytes([0x78, 0x01]) + raw
            + native.adler32(buf.tobytes()).to_bytes(4, "big"))


def compress(data, level: int = 2, backend: str = "device",
             config=None, stats: dict | None = None, device="cuda") -> bytes:
    """Compress to a raw DEFLATE stream (decodable by zlib wbits=-15).

    backend: "device" (the torch encoder on `device`, the default),
    "native" (the C++ host encoder, native/deflate.cpp), or "auto"
    (native for inputs below one 32 KiB block, where a device round trip
    costs more than the work).  The device encode runs in segments of at
    most 64 blocks, stitched on the host; its bytes do not depend on the
    segmentation.

    config: a ``CodecConfig``; when given it supplies level / backend /
    container (a "zlib" container wraps the stream per RFC 1950), and
    with emit_manifest the block-index manifest rides in
    stats["manifest"].  stats: an empty dict that receives a structured
    run report (utils/metrics.RunReport: ratio, MB/s, block-type
    histogram, from a second, size-only planning pass over all blocks).
    device: a torch device, the card by default; it must exist.
    """
    from deflate_tpu_torch._build import torch_device

    dev = torch_device(device)
    if config is not None:
        level = config.level
        backend = config.backend
        if config.emit_manifest:
            # one encode produces stream + block index (+ decode hints);
            # offsets index the RAW deflate stream (for zlib containers:
            # relative to the first byte after the header)
            if stats is None:
                raise ValueError(
                    "config.emit_manifest=True needs a stats dict to "
                    "receive the manifest")
            from deflate_tpu_torch.runtime import manifest as _mf

            inner, man = _mf.compress_with_manifest(data, level, device=dev)
            buf = _as_u8(data)
            stats.update({"op": "compress", "bytes_in": len(buf),
                          "bytes_out": len(inner), "manifest": man})
            if config.container == "zlib":
                return _zlib_wrap(inner, buf)
            return inner
        if config.container == "zlib":
            return _zlib_wrap(compress(data, level, backend, stats=stats,
                                       device=dev), _as_u8(data))
    _check_level(level)
    if backend not in ("device", "native", "auto"):
        raise ValueError(f"unknown backend {backend!r}")
    report = None
    if stats is not None:
        from deflate_tpu_torch.utils.metrics import RunReport

        report = RunReport("compress")
    buf = _as_u8(data)
    if backend == "native" or (backend == "auto" and len(buf) < BLOCK_SIZE):
        from deflate_tpu_torch import native

        out = native.deflate(buf.tobytes(), level)
        if report is not None:
            report.bytes_in = len(buf)
            report.bytes_out = len(out)
            report.extra["backend"] = "native"
            stats.update(report.finish())
        return out

    segments = _encode_segments(buf, level, dev)
    stream = _stitch.words_to_bytes(*_stitch.stitch_segments(segments))
    if report is not None:
        import torch

        from deflate_tpu_torch.models import encoder as E

        blocks, blens = split_blocks(buf)
        choice = E.plan_sizes(
            torch.from_numpy(blocks).to(dev), torch.from_numpy(blens).to(dev),
            torch.ones(len(blens), dtype=torch.bool, device=dev), level)[0]
        report.bytes_in = len(buf)
        report.bytes_out = len(stream)
        report.extra["backend"] = "device"
        report.extra["level"] = level
        report.add_blocks(choice.cpu().numpy())
        stats.update(report.finish())
    return stream


def decompress(data, out_size: int | None = None, device="cuda",
               config=None, stats: dict | None = None,
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
    when it flags the stream.  device=None is the host decoder.  config:
    a ``CodecConfig`` supplying device_decode (False: device=None) and
    container (a "zlib" container goes through ``decompress_zlib``).
    stats: an empty dict that receives a run report, including which
    decoder served (``device_path``: "wave", "pallas_scalar",
    "speculative", "native_host") and ``redirected``.
    """
    if config is not None:
        if not config.device_decode:
            device = None
        if config.container == "zlib":
            out = decompress_zlib(data, device=device)
            if stats is not None:
                stats.update({"op": "decompress", "bytes_in": len(data),
                              "bytes_out": len(out), "container": "zlib"})
            return out
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


def compress_zlib(data, level: int = 2, device="cuda") -> bytes:
    """Compress into a zlib (RFC 1950) container — the reference can only
    *read* zlib streams; this also writes them."""
    return _zlib_wrap(compress(data, level, device=device), _as_u8(data))


def compress_gzip(data, level: int = 2, device="cuda") -> bytes:
    """Compress into a gzip (RFC 1952) member — a container the reference
    has no support for at all (it reads zlib only, and writes raw)."""
    import zlib as _z

    raw = compress(data, level, device=device)
    payload = _as_u8(data).tobytes()
    hdr = bytes([0x1F, 0x8B, 8, 0, 0, 0, 0, 0, 0, 255])
    crc = _z.crc32(payload) & 0xFFFFFFFF
    isize = len(payload) & 0xFFFFFFFF
    return (hdr + raw + crc.to_bytes(4, "little")
            + isize.to_bytes(4, "little"))


def _gzip_member_payload_offset(buf: bytes, ofs: int) -> int:
    """Parse one gzip member header at `ofs`; return the payload offset.

    Verifies FHCRC (CRC-16 of the header) when present — the RFC 1952
    check the reference has no analog for.  Raises InflateError on any
    malformed header (truncated optional fields included).
    """
    import zlib as _z

    try:
        if buf[ofs] != 0x1F or buf[ofs + 1] != 0x8B:
            raise InflateError("not a gzip stream")
        if buf[ofs + 2] != 8:
            raise InflateError("unsupported gzip compression method")
        flg = buf[ofs + 3]
        if flg & 0xE0:
            raise InflateError("reserved gzip FLG bits set")
        p = ofs + 10
        if flg & 0x04:                               # FEXTRA
            xlen = int.from_bytes(buf[p:p + 2], "little")
            p += 2 + xlen
            if p > len(buf):
                raise InflateError("gzip FEXTRA truncated")
        if flg & 0x08:                               # FNAME
            p = buf.index(0, p) + 1
        if flg & 0x10:                               # FCOMMENT
            p = buf.index(0, p) + 1
        if flg & 0x02:                               # FHCRC
            stored = int.from_bytes(buf[p:p + 2], "little")
            if _z.crc32(buf[ofs:p]) & 0xFFFF != stored:
                raise InflateError("gzip header crc16 mismatch")
            p += 2
        if p + 8 > len(buf):                         # payload + trailer room
            raise InflateError("gzip member truncated")
        return p
    except (IndexError, ValueError) as e:
        if isinstance(e, InflateError):
            raise
        raise InflateError("malformed gzip header") from None


def decompress_gzip(data) -> bytes:
    """Decompress a gzip (RFC 1952) file on the host: one or more
    concatenated members (RFC 1952 §2.2 — `gzip -c a b > ab.gz` style),
    verifying each member's CRC-32, ISIZE, and (when present) header
    CRC-16."""
    import zlib as _z

    from deflate_tpu_torch import native

    buf = bytes(data)
    if len(buf) < 18:
        raise InflateError("not a gzip stream")
    parts = []
    ofs = 0
    while ofs < len(buf):
        p = _gzip_member_payload_offset(buf, ofs)
        payload = buf[p:]
        try:
            out, consumed = native.inflate_consumed(
                payload, max(1024, 8 * len(payload)))
        except ValueError as e:
            raise InflateError(str(e)) from None
        t = p + consumed
        if t + 8 > len(buf):
            raise InflateError("gzip trailer truncated")
        crc = int.from_bytes(buf[t:t + 4], "little")
        isize = int.from_bytes(buf[t + 4:t + 8], "little")
        if _z.crc32(out) & 0xFFFFFFFF != crc:
            raise InflateError("gzip crc32 mismatch")
        if len(out) & 0xFFFFFFFF != isize:
            raise InflateError("gzip isize mismatch")
        parts.append(out)
        ofs = t + 8
    return b"".join(parts)


def compress_many(buffers, level: int = 2, device="cuda") -> list:
    """Compress many independent buffers in one device batch.

    The production-serving shape: B streams encode as one batched call
    (encoder.encode_blocks_multi) instead of B separate calls.  Each
    buffer becomes its own raw DEFLATE stream (own BFINAL block, own bit
    phase 0), stitched per stream on the host; each equals ``compress``
    of that buffer.
    """
    import torch

    from deflate_tpu_torch._build import torch_device
    from deflate_tpu_torch.models import encoder as E

    dev = torch_device(device)
    _check_level(level)
    split = [split_blocks(b) for b in buffers]
    nbs = [len(s[1]) for s in split]
    blocks = np.concatenate([s[0] for s in split])
    blens = np.concatenate([s[1] for s in split])
    owner = np.repeat(np.arange(len(nbs), dtype=np.int32), nbs)
    finals = np.zeros(len(blens), bool)
    finals[np.cumsum(nbs) - 1] = True
    words, bits = E.encode_blocks_multi(
        torch.from_numpy(blocks).to(dev), torch.from_numpy(blens).to(dev),
        torch.ones(len(blens), dtype=torch.bool, device=dev),
        torch.from_numpy(finals).to(dev), torch.from_numpy(owner).to(dev),
        level)
    words, bits = words.cpu().numpy(), bits.cpu().numpy()
    out = []
    i = 0
    for nb in nbs:
        w, t = _stitch.stitch_segments(
            [(words[i + j], int(bits[i + j])) for j in range(nb)])
        out.append(_stitch.words_to_bytes(w, t))
        i += nb
    return out


def decompress_many(streams, device="cuda") -> list:
    """Decompress many independent raw DEFLATE streams (each through
    ``decompress`` with its defaults: on the host, the card present)."""
    return [decompress(s, device=device) for s in streams]


def compress_file(src: str, dst: str, level: int = 2,
                  chunk_blocks: int = 256, device="cuda") -> None:
    """Streaming file->file compression in bounded memory.

    Reads `chunk_blocks` 32 KiB blocks at a time (8 MiB by default),
    encodes each chunk on `device` in segments of at most 64 blocks (as
    ``compress`` does), and appends complete bytes to the output while
    carrying the bit-level tail across chunks — the reference's BitFile
    flush-on-byte-boundary behavior (deflate.hpp:160-182), without its
    single-shot memory profile.  The output equals ``compress`` of the
    file's bytes for every chunk_blocks.
    """
    import os as _os

    from deflate_tpu_torch._build import torch_device

    dev = torch_device(device)
    _check_level(level)
    size = _os.path.getsize(src)
    phase = 0
    tail_byte = 0                   # partial byte carried across chunks
    with open(src, "rb") as fin, open(dst, "wb") as fout:
        while True:
            data = fin.read(chunk_blocks * BLOCK_SIZE)
            final = fin.tell() >= size
            segs = _encode_segments(np.frombuffer(data, dtype=np.uint8),
                                    level, dev, phase, final)
            # merge the carried tail with this chunk at bit offset phase
            w, bits = _stitch.stitch_segments(
                [(np.array([tail_byte], np.uint32), phase)] + segs)
            stream = _stitch.words_to_bytes(w, bits)
            full = bits // 8
            fout.write(stream[:full])
            phase = bits & 7
            tail_byte = stream[full] if phase else 0
            if final:
                break
        if phase:
            fout.write(bytes([tail_byte]))


def decompress_file(src: str, dst: str, chunk_bytes: int = 1 << 23) -> None:
    """Streaming file->file decompression in bounded memory, on the host.

    Decodes block by block with a sliding input window and a 32 KiB
    output-history window (cross-block back-references are RFC-legal in
    foreign streams), so peak memory is O(chunk_bytes), independent of
    the file size.  Blocks spanning a read boundary are handled by
    extending the window and retrying — the case the reference's chunked
    file path gets wrong (inflate.hpp:390-408, SURVEY.md B5).
    """
    with open(src, "rb") as fin, open(dst, "wb") as fout:
        ibuf = bytearray(fin.read(chunk_bytes))
        eof = len(ibuf) < chunk_bytes
        ibase = 0                       # absolute byte offset of ibuf[0]
        bitpos = 0                      # absolute bit position
        history = b""
        while True:
            local = bitpos - 8 * ibase
            try:
                out, end_local, bfinal = _hi.inflate_block_streaming(
                    bytes(ibuf), local, history)
            except (InflateError, IndexError):
                if eof:
                    raise InflateError(
                        f"truncated or corrupt stream near bit {bitpos}"
                    ) from None
                more = fin.read(chunk_bytes)
                eof = len(more) < chunk_bytes
                ibuf += more
                continue
            fout.write(out)
            history = (history + out)[-32768:]
            bitpos = 8 * ibase + end_local
            if bfinal:
                break
            drop = (bitpos // 8) - ibase
            if drop > chunk_bytes // 2:          # slide consumed input out
                del ibuf[:drop]
                ibase += drop
            if not eof and len(ibuf) - (bitpos // 8 - ibase) \
                    < chunk_bytes // 2:
                more = fin.read(chunk_bytes)
                eof = len(more) < chunk_bytes
                ibuf += more
