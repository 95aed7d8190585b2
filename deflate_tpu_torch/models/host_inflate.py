"""Host-side sequential INFLATE — the CPU fallback decoder and test oracle.

Decodes any conforming RFC 1951 stream (all three block types, cross-block
back-references).  Reference analog: `class inflate` (inflate.hpp:26-409),
whose hot loop probes a trie once per input *bit*; here symbols decode via
canonical first-code/limit arithmetic (table-driven, no tries).  The
device decode path is models/wave_decoder.py; this module is the
always-available, dependency-free correctness anchor and the per-block
fallback of runtime/manifest.decode_all.

Copied from deflate_tpu/models/host_inflate.py, which imports no JAX:
the raw-stream decoder, the consumed-bytes decode (gzip members), the
streaming block decode (decompress_file), the zlib container and
Adler-32.
"""
from __future__ import annotations

import numpy as np

from deflate_tpu_torch.utils.tables import (CL_ORDER, DIST_BASE,
                                            DIST_EXTRA, FIXED_DIST_LENGTHS,
                                            FIXED_LITLEN_LENGTHS,
                                            LENGTH_BASE, LENGTH_EXTRA)


class InflateError(ValueError):
    """Raised on malformed DEFLATE input (corrupt stream detection, §5.3)."""


class _BitReader:
    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0                       # absolute bit position
        self.nbits = 8 * len(data)

    def read(self, n: int) -> int:
        p = self.pos
        if p + n > self.nbits:
            raise InflateError("unexpected end of stream")
        byte = p >> 3
        # pull up to 4 bytes; n <= 16 always here
        acc = int.from_bytes(self.data[byte:byte + 4], "little")
        out = (acc >> (p & 7)) & ((1 << n) - 1)
        self.pos = p + n
        return out

    def align_byte(self):
        self.pos = (self.pos + 7) & ~7


class _Canon:
    """Canonical decoder: first-code/limit arithmetic per length."""

    __slots__ = ("first", "lim", "base", "syms", "maxlen")

    def __init__(self, lengths: np.ndarray):
        lengths = np.asarray(lengths, dtype=np.int64)
        maxlen = int(lengths.max(initial=0))
        counts = np.bincount(lengths, minlength=maxlen + 1)
        counts[0] = 0
        # Kraft check: reject oversubscribed codes
        kraft = int(np.sum(counts * (1 << (maxlen - np.arange(maxlen + 1)))))
        if maxlen and kraft > (1 << maxlen):
            raise InflateError("oversubscribed code lengths")
        first = np.zeros(maxlen + 2, dtype=np.int64)
        code = 0
        for l in range(1, maxlen + 1):
            code = (code + counts[l - 1]) << 1
            first[l] = code
        self.first = first
        self.lim = first[:maxlen + 1] + counts
        self.base = np.cumsum(counts) - counts
        order = np.argsort(lengths * 1024 + np.arange(len(lengths))
                           + (lengths == 0) * (1 << 20))
        self.syms = order
        self.maxlen = maxlen

    def decode(self, br: _BitReader) -> int:
        c = 0
        for l in range(1, self.maxlen + 1):
            c = (c << 1) | br.read(1)
            if c < self.lim[l]:
                return int(self.syms[self.base[l] + c - self.first[l]])
        raise InflateError("invalid Huffman code")


_FIXED_LIT = None
_FIXED_DIST = None


def _fixed_tables():
    global _FIXED_LIT, _FIXED_DIST
    if _FIXED_LIT is None:
        _FIXED_LIT = _Canon(FIXED_LITLEN_LENGTHS)
        _FIXED_DIST = _Canon(FIXED_DIST_LENGTHS)
    return _FIXED_LIT, _FIXED_DIST


def _read_dynamic_tables(br: _BitReader):
    """Parse HLIT/HDIST/HCLEN + RLE code lengths (RFC 1951 §3.2.7)."""
    hlit = br.read(5) + 257
    hdist = br.read(5) + 1
    hclen = br.read(4) + 4
    cl_lens = np.zeros(19, dtype=np.int64)
    for k in range(hclen):
        cl_lens[CL_ORDER[k]] = br.read(3)
    cl = _Canon(cl_lens)
    lens = np.zeros(hlit + hdist, dtype=np.int64)
    i = 0
    while i < hlit + hdist:
        s = cl.decode(br)
        if s < 16:
            lens[i] = s
            i += 1
        elif s == 16:
            if i == 0:
                raise InflateError("repeat with no previous length")
            rep = 3 + br.read(2)
            lens[i:i + rep] = lens[i - 1]
            i += rep
        elif s == 17:
            i += 3 + br.read(3)
        else:
            i += 11 + br.read(7)
    if i != hlit + hdist:
        raise InflateError("code length overflow")
    if lens[256] == 0:
        raise InflateError("no end-of-block code")
    return _Canon(lens[:hlit]), _Canon(lens[hlit:])


def inflate_raw_consumed(data: bytes, max_out: int | None = None):
    """Decode one raw DEFLATE stream; return (bytes, input bytes consumed).

    A partially-read final byte counts as consumed — the returned offset is
    where a container trailer or the next concatenated member begins.
    """
    br = _BitReader(data)
    out = _inflate_loop(br, max_out, single_block=False)
    return out, (br.pos + 7) >> 3


def inflate_raw(data: bytes, max_out: int | None = None,
                start_bit: int = 0, single_block: bool = False,
                history: bytes = b"") -> bytes:
    """Decode a raw DEFLATE stream to bytes.

    start_bit / single_block support random-access block decode from a
    manifest (runtime/manifest.py): begin at an arbitrary bit offset and
    stop after one block regardless of BFINAL.  ``history`` seeds the
    back-reference window (last <=32 KiB of already-decoded output) for
    streaming block-by-block decode of foreign streams whose matches
    cross block boundaries (RFC-legal; inflate.hpp:284,268).
    """
    br = _BitReader(data)
    br.pos = start_bit
    return _inflate_loop(br, max_out, single_block, history)


def inflate_block_streaming(data: bytes, start_bit: int,
                            history: bytes = b""):
    """Decode ONE block starting at ``start_bit``; returns
    (new_bytes, end_bit, bfinal) — the resume triple for bounded-memory
    file decode (the working analog of the reference's broken chunked
    file path, inflate.hpp:390-408, B5)."""
    br = _BitReader(data)
    br.pos = start_bit
    bfinal = (data[start_bit >> 3] >> (start_bit & 7)) & 1
    out = _inflate_loop(br, None, True, history)
    return out, br.pos, bool(bfinal)


def _inflate_loop(br: _BitReader, max_out: int | None,
                  single_block: bool, history: bytes = b"") -> bytes:
    data = br.data
    out = bytearray(history)
    nhist = len(history)
    while True:
        bfinal = br.read(1)
        btype = br.read(2)
        if btype == 0:
            br.align_byte()
            ln = br.read(16)
            nlen = br.read(16)
            if ln ^ nlen != 0xFFFF:
                raise InflateError("stored block LEN/NLEN mismatch")
            byte = br.pos >> 3
            if byte + ln > len(data):
                raise InflateError("stored block truncated")
            out += data[byte:byte + ln]
            br.pos += 8 * ln
        elif btype in (1, 2):
            if btype == 1:
                lit, dist = _fixed_tables()
            else:
                lit, dist = _read_dynamic_tables(br)
            while True:
                s = lit.decode(br)
                if s < 256:
                    out.append(s)
                elif s == 256:
                    break
                else:
                    if s > 285:
                        raise InflateError(f"invalid length symbol {s}")
                    li = s - 257
                    length = int(LENGTH_BASE[li]) + br.read(int(LENGTH_EXTRA[li]))
                    d = dist.decode(br)
                    if d > 29:
                        raise InflateError(f"invalid distance symbol {d}")
                    distance = int(DIST_BASE[d]) + br.read(int(DIST_EXTRA[d]))
                    if distance > len(out):
                        raise InflateError("distance too far back")
                    start = len(out) - distance
                    if distance >= length:
                        out += out[start:start + length]
                    else:                      # overlapping copy
                        for j in range(length):
                            out.append(out[start + j])
            if max_out is not None and len(out) - nhist > max_out:
                raise InflateError("output exceeds declared size")
        else:
            raise InflateError("invalid block type 3")
        if bfinal or single_block:
            return bytes(out[nhist:])


def adler32(data: bytes) -> int:
    # flat numpy formulation: s1 = 1 + sum(d); s2 = len + sum((len-i)*d)
    d = np.frombuffer(data, dtype=np.uint8).astype(np.uint64)
    n = len(d)
    s1 = (1 + int(d.sum())) % 65521
    s2 = (n + int((d * (n - np.arange(n, dtype=np.uint64))).sum())) % 65521
    return (s2 << 16) | s1


def zlib_unwrap(data: bytes) -> tuple[bytes, int]:
    """Check a zlib (RFC 1950) header; return (the raw DEFLATE payload
    with the trailer after it, the trailer's Adler-32)."""
    if len(data) < 6:
        raise InflateError("zlib stream too short")
    cmf, flg = data[0], data[1]
    if cmf & 0x0F != 8:
        raise InflateError("unsupported compression method")
    if (cmf * 256 + flg) % 31 != 0:
        raise InflateError("bad zlib header check")
    ofs = 6 if flg & 0x20 else 2   # FDICT (reference mis-parses this — B4)
    return data[ofs:], int.from_bytes(data[-4:], "big")


def check_adler32(out: bytes, stored: int) -> bytes:
    """out, if its Adler-32 is `stored`; else InflateError."""
    if adler32(out) != stored:
        raise InflateError("adler32 mismatch")
    return out


def inflate_zlib(data: bytes) -> bytes:
    """Unwrap a zlib (RFC 1950) container and decode the payload,
    verifying its Adler-32."""
    payload, stored = zlib_unwrap(data)
    return check_adler32(inflate_raw(payload), stored)
