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
  decode_range(stream, man, start, end, device=dev) -> bytes

``device`` is a torch device and defaults to the card ("cuda"); without
one these raise.  device="cpu" runs the same torch path with the plain
kernel versions (the tests do).  device=None in decode_all and
decode_range is the host decoder, the reference's device=False.
decode_range decodes only the range's blocks, through the block decode
decode_all uses.
"""
from __future__ import annotations

import base64
import bisect
import dataclasses
import itertools
import json

import numpy as np

from deflate_tpu_torch.utils import metrics
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

    def hint_array(self, idxs=None):
        """[B, maxchunks] uint8 hints padded with HINT_NONE, or None; with
        idxs, the rows of those blocks alone, in that order."""
        if self.hints is None:
            return None
        from deflate_tpu_torch.ops.wave import HINT_NONE
        rows = (self.hints if idxs is None
                else [self.hints[i] for i in idxs])
        cap = max((len(h) for h in rows), default=1)
        out = np.full((len(rows), cap), HINT_NONE, np.uint8)
        for i, h in enumerate(rows):
            out[i, :len(h)] = np.frombuffer(h, np.uint8)
        return out

    @property
    def out_size(self) -> int:
        return sum(b[2] for b in self.blocks)

    def out_starts(self) -> list[int]:
        """The output offset of each block, and the output size last."""
        return [0, *itertools.accumulate(b[2] for b in self.blocks)]

    def blocks_for_range(self, start: int, end: int):
        """Indices of blocks covering output bytes [start, end): those
        that end after start and begin before end."""
        return list(range(*_cover(self.out_starts(), start, end)))


def _cover(starts, start: int, end: int) -> tuple[int, int]:
    """(i0, i1): the blocks i0..i1-1 that end after start and begin
    before end, bisected in starts (Manifest.out_starts())."""
    i0 = bisect.bisect_right(starts, start, 1) - 1
    i1 = bisect.bisect_left(starts, end, 0, len(starts) - 1)
    return i0, max(i0, i1)


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(data), dtype=np.uint8)
    a = np.asarray(data)
    if a.dtype != np.uint8:
        raise TypeError(f"expected bytes or uint8 array, got {a.dtype}")
    return a.reshape(-1)


def split_blocks(data):
    """bytes or a uint8 array -> (blocks uint8 [n, BLOCK_SIZE] zero
    padded, blens int32 [n]), numpy; one empty block for empty input."""
    buf = _as_u8(data)
    nblocks = max(1, -(-len(buf) // BLOCK_SIZE))
    padded = np.zeros(nblocks * BLOCK_SIZE, np.uint8)
    padded[:len(buf)] = buf
    blens = np.clip(len(buf) - BLOCK_SIZE * np.arange(nblocks), 0,
                    BLOCK_SIZE).astype(np.int32)
    return padded.reshape(nblocks, BLOCK_SIZE), blens


def manifest_of(words, total, offset, bits, harr, blens):
    """(stream bytes, Manifest) from an encode of split_blocks' blocks:
    encoder.encode_batch_with_hints' outputs (harr None: no hints)."""
    from deflate_tpu_torch.ops.wave import HINT_NONE
    from deflate_tpu_torch.runtime import stitch as S

    stream = S.words_to_bytes(metrics.to_host(words).numpy(),
                              int(metrics.to_host(total)))
    offset = metrics.to_host(offset).numpy()
    bits = metrics.to_host(bits).numpy()
    hlist = None
    if harr is not None:
        harr = metrics.to_host(harr).numpy().astype(np.uint8)
        hlist = []
        for i in range(len(blens)):
            h = harr[i, :int(-(-bits[i] // 64))]
            # trim trailing no-symbol chunks (stored blocks -> empty;
            # post-EOB tail chunks) so every kept phase fits 6 bits
            keep = np.nonzero(h != HINT_NONE)[0]
            hlist.append(h[:keep[-1] + 1].tobytes() if len(keep) else b"")
    man = Manifest(BLOCK_SIZE, int(offset[-1] + bits[-1]),
                   [(int(offset[i]), int(bits[i]), int(blens[i]))
                    for i in range(len(blens))], hlist)
    return stream, man


def compress_with_manifest(data, level: int = 2, hints: bool = True,
                           device="cuda"):
    """Compress on `device` (a torch device: the card by default, "cpu"
    for the plain kernel versions) and return (stream bytes, Manifest).
    One encode produces the stream, the per-block spans and the
    wavefront decode hints."""
    import torch

    from deflate_tpu_torch._build import torch_device
    from deflate_tpu_torch.models import encoder as E

    dev = torch_device(device)
    with metrics.span("encode"):
        with metrics.span("encode.split"):
            blocks, blens = split_blocks(data)
            n = len(blens)
            blocks_d = metrics.to_device(blocks, dev)
            blens_d = metrics.to_device(blens, dev)
        out = E._encode(blocks_d, blens_d,
                        torch.ones(n, dtype=torch.bool, device=dev), n - 1,
                        level, 0, hints)
        with metrics.span("encode.to_host"):
            return manifest_of(*out, blens)


def decode_all(stream: bytes, man: Manifest, device="cuda") -> bytes:
    """Decode an entire manifest-indexed stream on `device` (a torch
    device: the card by default, "cpu" for the plain kernel versions).

    With hints, the wavefront decoder (models/wave_decoder.py) decodes
    every block; blocks it flags fall back to the host decoder one by
    one.  Without hints, kernel K6 (models/block_decoder.py) decodes all
    blocks; if it flags any, the whole stream decodes on the host.
    device=None decodes every block on the host (the reference's
    device=False).  Counts the blocks sent to the host in
    decode.blocks_fallback, and the decoder that served in
    decode.path.wave or decode.path.pallas_scalar."""
    with metrics.span("decode"):
        hints = None if device is None else man.hint_array()
        parts = _decode_blocks(stream, man.blocks, hints, device)
        with metrics.span("decode.to_host"):
            return b"".join(parts)


def _decode_blocks(stream: bytes, blocks, hints, device) -> list:
    """Decode `blocks` ((bit_offset, bit_len, out_len) triples, in stream
    order) of `stream`: decode_all's decoders, on any run of a stream's
    blocks.  hints: their [len(blocks), n] entry-phase rows, or None.
    Returns buffers (bytes or uint8 views of the device's rows) whose
    concatenation is the blocks' output."""
    from deflate_tpu_torch.models import host_inflate as HI

    if device is not None and hints is not None:
        from deflate_tpu_torch.models import wave_decoder as WD

        words, produced, err = WD.inflate_wave_device(
            stream, [b[0] for b in blocks], [b[2] for b in blocks], hints,
            device=device)
        metrics.count("decode.path.wave")
        bad = [i for i, (_, _, olen) in enumerate(blocks)
               if err[i] or produced[i] != olen]
        redo = {}
        if bad:                                     # per-block fallback
            metrics.count("decode.blocks_fallback", len(bad))
            with metrics.span("decode.fallback"):
                for i in bad:
                    redo[i] = HI.inflate_raw(
                        stream, start_bit=blocks[i][0], single_block=True)
        with metrics.span("decode.to_host"):
            w = np.asarray(words).view(np.uint8).reshape(len(blocks), -1)
            return [redo[i] if i in redo else w[i, :olen]
                    for i, (_, _, olen) in enumerate(blocks)]
    if device is not None:
        from deflate_tpu_torch.models import block_decoder as BD

        try:
            out = BD.inflate_manifest(stream, blocks, device=device)
        except BD.PallasDecodeError:                # whole-run fallback
            metrics.count("decode.blocks_fallback", len(blocks))
        else:
            metrics.count("decode.path.pallas_scalar")
            return [out]
    with metrics.span("decode.fallback"):
        return [HI.inflate_raw(stream, start_bit=bit_off, single_block=True)
                for bit_off, _, _ in blocks]


def decode_range(stream: bytes, man: Manifest, start: int, end: int,
                 device="cuda") -> bytes:
    """Random-access decode of output bytes [start, end) on `device`,
    without touching the rest of the stream — possible because blocks
    are independent (Q5).

    Cuts the stream to the byte span of the range's blocks, with their
    offsets rebased (the in-byte phase kept: a stored block's padding
    depends on it), and decodes those alone through decode_all's block
    decode: on a torch device ("cuda" by default, or "cpu" for the plain
    kernel versions) the wavefront with hints and K6 without, blocks it
    flags going to the host (decode.blocks_fallback); with device=None
    every block on the host.  Counts the blocks, their decoded bytes and
    the bytes returned in decode.range_blocks, decode.range_bytes_decoded
    and decode.range_bytes_returned."""
    if start < 0:
        raise ValueError(f"decode_range: start {start} < 0")
    with metrics.span("decode"):
        with metrics.span("decode.range_plan"):
            starts = man.out_starts()
            end = min(end, starts[-1])
            if start >= end:
                return b""
            i0, i1 = _cover(starts, start, end)
            first = man.blocks[i0][0] // 8
            last_off, last_len, _ = man.blocks[i1 - 1]
            sub = stream[first:-(-(last_off + last_len) // 8)]
            blocks = [(off - 8 * first, bl, ol)
                      for off, bl, ol in man.blocks[i0:i1]]
            hints = (None if device is None
                     else man.hint_array(range(i0, i1)))
        metrics.count("decode.range_blocks", i1 - i0)
        metrics.count("decode.range_bytes_decoded", starts[i1] - starts[i0])
        metrics.count("decode.range_bytes_returned", end - start)
        parts = _decode_blocks(sub, blocks, hints, device)
        with metrics.span("decode.to_host"):
            lo, hi = start - starts[i0], end - starts[i0]
            kept, pos = [], 0
            for p in parts:
                n = len(p)
                if pos < hi and pos + n > lo:
                    kept.append(memoryview(p)[max(lo - pos, 0):hi - pos])
                pos += n
            return b"".join(kept)
