"""Block-index manifest: seekable, parallel-decodable streams, and the
main path's two entry points.

The ``Manifest`` class and its binary form (magic "DTM3", varint block
table, hints packed at 6 bits per chunk) are copied from
deflate_tpu/runtime/manifest.py so both packages read each other's
manifests byte for byte.  Because the encoder keeps blocks independent
(matches never cross block boundaries), any block decodes from its bit
span alone; the per-64-bit-chunk entry phases ("hints") let the
wavefront decoder (models/wave_decoder.py) decode every chunk of every
block independently.

  compress_with_manifest(data, level=2, device=dev) -> (stream, Manifest)
  decode_all(stream, man, device=dev) -> bytes
"""
from __future__ import annotations

import base64
import dataclasses
import json

import numpy as np

from deflate_tpu_torch.utils.tables import BLOCK_SIZE

VERSION = 3

_MAGIC = b"DTM3"


def _write_varint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return


def _read_varint(buf: bytes, p: int):
    v = s = 0
    while True:
        b = buf[p]
        p += 1
        v |= (b & 0x7F) << s
        if not b & 0x80:
            return v, p
        s += 7


def _pack6(vals: bytes) -> bytes:
    """Pack byte values < 64 at 6 bits each, LSB-first."""
    a = np.frombuffer(vals, np.uint8).astype(np.uint32)
    assert (a < 64).all(), "hint phase out of 6-bit range"
    n = len(a)
    bits = np.zeros(n * 6, np.uint8)
    for i in range(6):
        bits[i::6] = (a >> i) & 1
    pad = (-len(bits)) % 8
    bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    return np.packbits(bits.reshape(-1, 8)[:, ::-1]).tobytes()


def _unpack6(data: bytes, n: int) -> bytes:
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    bits = bits.reshape(-1, 8)[:, ::-1].reshape(-1)[:n * 6]
    a = np.zeros(n, np.uint8)
    for i in range(6):
        a |= (bits[i::6] << i).astype(np.uint8)
    return a.tobytes()


@dataclasses.dataclass
class Manifest:
    block_size: int
    total_bits: int
    blocks: list[tuple[int, int, int]]     # (bit_offset, bit_len, out_len)
    hints: list[bytes] | None = None       # per-block chunk entry phases

    def to_json(self) -> str:
        d = {"version": VERSION, "block_size": self.block_size,
             "total_bits": self.total_bits,
             "blocks": [list(b) for b in self.blocks]}
        if self.hints is not None:
            d["hints"] = base64.b64encode(b"".join(self.hints)).decode()
            d["hint_lens"] = [len(h) for h in self.hints]
        return json.dumps(d)

    def to_bytes(self) -> bytes:
        """Binary form: magic, counts, varint block table (bit_len and
        out_len delta-free; bit_off implicit as a running sum), then
        per-block varint hint lengths and one 6-bit-packed hint blob."""
        out = bytearray(_MAGIC)
        _write_varint(out, self.block_size)
        _write_varint(out, self.total_bits)
        _write_varint(out, len(self.blocks))
        prev = 0
        for off, bl, ol in self.blocks:
            assert off == prev, "blocks must be contiguous"
            _write_varint(out, bl)
            _write_varint(out, ol)
            prev = off + bl
        if self.hints is None:
            out.append(0)
        else:
            out.append(1)
            blob = b"".join(self.hints)
            for h in self.hints:
                _write_varint(out, len(h))
            packed = _pack6(blob)
            _write_varint(out, len(blob))
            out += packed
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Manifest":
        if data[:4] != _MAGIC:
            raise ValueError("bad manifest magic")
        p = 4
        bs, p = _read_varint(data, p)
        tb, p = _read_varint(data, p)
        nb, p = _read_varint(data, p)
        blocks = []
        off = 0
        for _ in range(nb):
            bl, p = _read_varint(data, p)
            ol, p = _read_varint(data, p)
            blocks.append((off, bl, ol))
            off += bl
        hints = None
        if data[p]:
            p += 1
            lens = []
            for _ in range(nb):
                n, p = _read_varint(data, p)
                lens.append(n)
            total, p = _read_varint(data, p)
            blob = _unpack6(data[p:], total)
            hints, q = [], 0
            for n in lens:
                hints.append(blob[q:q + n])
                q += n
        return cls(bs, tb, blocks, hints)

    @classmethod
    def from_json(cls, s: str) -> "Manifest":
        d = json.loads(s)
        if d.get("version") not in (1, 2, 3):
            raise ValueError(f"unsupported manifest version {d.get('version')}")
        hints = None
        if d.get("hints") is not None:
            blob = base64.b64decode(d["hints"])
            hints, p = [], 0
            for n in d["hint_lens"]:
                hints.append(blob[p:p + n])
                p += n
        return cls(d["block_size"], d["total_bits"],
                   [tuple(b) for b in d["blocks"]], hints)

    def hint_array(self):
        """[B, maxchunks] uint8 hints padded with HINT_NONE, or None."""
        if self.hints is None:
            return None
        from deflate_tpu_torch.ops.wave import HINT_NONE
        cap = max((len(h) for h in self.hints), default=1)
        out = np.full((len(self.hints), cap), HINT_NONE, np.uint8)
        for i, h in enumerate(self.hints):
            out[i, :len(h)] = np.frombuffer(h, np.uint8)
        return out

    @property
    def out_size(self) -> int:
        return sum(b[2] for b in self.blocks)

    def blocks_for_range(self, start: int, end: int):
        """Indices of blocks covering output bytes [start, end)."""
        out = []
        pos = 0
        for i, (_, _, olen) in enumerate(self.blocks):
            if pos < end and pos + olen > start:
                out.append(i)
            pos += olen
            if pos >= end:
                break
        return out


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(data), dtype=np.uint8)
    a = np.asarray(data)
    if a.dtype != np.uint8:
        raise TypeError(f"expected bytes or uint8 array, got {a.dtype}")
    return a.reshape(-1)


def compress_with_manifest(data, level: int = 2, hints: bool = True,
                           device=None):
    """Compress on `device` (a torch.device; default CPU) and return
    (stream bytes, Manifest).  One encode produces the stream, the
    per-block spans and the wavefront decode hints."""
    import torch

    from deflate_tpu_torch.models import encoder as E
    from deflate_tpu_torch.ops.wave import HINT_NONE
    from deflate_tpu_torch.runtime import stitch as S

    dev = torch.device("cpu") if device is None else torch.device(device)
    buf = _as_u8(data)
    nblocks = max(1, -(-len(buf) // BLOCK_SIZE))
    blocks = np.zeros((nblocks, BLOCK_SIZE), np.uint8)
    blens = np.zeros((nblocks,), np.int32)
    for i in range(nblocks):
        chunk = buf[i * BLOCK_SIZE:(i + 1) * BLOCK_SIZE]
        blocks[i, :len(chunk)] = chunk
        blens[i] = len(chunk)
    words, total, offset, bits, harr = E._encode(
        torch.from_numpy(blocks).to(dev), torch.from_numpy(blens).to(dev),
        torch.ones(nblocks, dtype=torch.bool, device=dev), nblocks - 1,
        level, 0, hints)
    stream = S.words_to_bytes(words.cpu().numpy(), int(total))
    offset = offset.cpu().numpy()
    bits = bits.cpu().numpy()
    hlist = None
    if hints:
        harr = harr.cpu().numpy().astype(np.uint8)
        hlist = []
        for i in range(nblocks):
            h = harr[i, :int(-(-bits[i] // 64))]
            # trim trailing no-symbol chunks (stored blocks -> empty;
            # post-EOB tail chunks) so every kept phase fits 6 bits
            keep = np.nonzero(h != HINT_NONE)[0]
            hlist.append(h[:keep[-1] + 1].tobytes() if len(keep) else b"")
    man = Manifest(BLOCK_SIZE, int(offset[-1] + bits[-1]),
                   [(int(offset[i]), int(bits[i]), int(blens[i]))
                    for i in range(nblocks)], hlist)
    return stream, man


def decode_all(stream: bytes, man: Manifest, device=None) -> bytes:
    """Decode an entire manifest-indexed stream.

    With a `device` and a manifest that carries hints, the wavefront
    decoder (models/wave_decoder.py) decodes every block there; blocks it
    flags fall back to the host decoder one by one.  Without a device or
    without hints, every block decodes on the host."""
    from deflate_tpu_torch.models import host_inflate as HI

    if device is not None and man.hints is not None:
        from deflate_tpu_torch.models import wave_decoder as WD

        offs = [b[0] for b in man.blocks]
        sizes = [b[2] for b in man.blocks]
        words, produced, err = WD.inflate_wave_device(
            stream, offs, sizes, man.hint_array(), device=device)
        w = np.asarray(words).view(np.uint8).reshape(len(man.blocks), -1)
        parts = []
        for i, (bit_off, _, olen) in enumerate(man.blocks):
            if err[i] or produced[i] != olen:       # per-block fallback
                parts.append(HI.inflate_raw(stream, start_bit=bit_off,
                                            single_block=True))
            else:
                parts.append(w[i, :olen].tobytes())
        return b"".join(parts)
    out = bytearray()
    for bit_off, _, _ in man.blocks:
        out += HI.inflate_raw(stream, start_bit=bit_off, single_block=True)
    return bytes(out)
