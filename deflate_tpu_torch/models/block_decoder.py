"""Device inflate of self-contained blocks through kernel K6
(ops/block_inflate.py).  Port of deflate_tpu/models/pallas_decoder.py.

Two entry points:

- ``inflate_manifest(stream, blocks)``: decode all blocks of a
  manifest-indexed stream in batched launches — the device decode of a
  manifest written without hints.
- ``inflate_stream(stream)``: decode a raw stream of self-contained
  blocks without a manifest by chaining blocks through the kernel's end
  bit, one launch per block (a fallback path, not a throughput path).

Both raise ``PallasDecodeError`` (the reference's name, which callers
catch) when the kernel flags a block: a corrupt stream, or a foreign
stream whose matches cross block boundaries, which a per-block window
cannot represent.  ``device`` is a torch device: the card by default,
"cpu" for the plain version.
"""
from __future__ import annotations

import numpy as np


class PallasDecodeError(Exception):
    pass


BATCH = 256                   # blocks per launch (8 MiB of output rows)
MAX_BLOCKS = 1 << 20          # inflate_stream's cap on chained blocks


def inflate_manifest(stream: bytes, blocks, device="cuda") -> bytes:
    """Decode manifest-indexed blocks, BATCH per launch.  ``blocks`` is an
    iterable of (bit_offset, bit_len, out_len) triples
    (runtime/manifest.py format).

    Returns the concatenated output; raises PallasDecodeError if any
    block errs or produces another size than the manifest's."""
    from deflate_tpu_torch.ops import block_inflate as BI

    blocks = list(blocks)
    if not blocks:
        return b""
    offs = np.asarray([b[0] for b in blocks], np.int64)
    out_lens = np.asarray([b[2] for b in blocks], np.int64)
    parts = []
    for s in range(0, len(blocks), BATCH):
        sl = slice(s, min(s + BATCH, len(blocks)))
        o, produced, err, _ = BI.inflate_blocks(stream, offs[sl],
                                                device=device)
        want = out_lens[sl]
        if np.any(err != 0) or np.any(produced != want):
            bad = int(np.argmax((err != 0) | (produced != want)))
            raise PallasDecodeError(
                f"block {s + bad}: err={int(err[bad])} "
                f"produced={int(produced[bad])} want={int(want[bad])}")
        for i in range(o.shape[0]):
            parts.append(o[i, :want[i]].tobytes())
    return b"".join(parts)


def inflate_stream(stream: bytes, device="cuda") -> bytes:
    """Decode a raw DEFLATE stream of self-contained blocks by chaining
    kernel calls; the host reads only each block's BFINAL bit."""
    from deflate_tpu_torch.ops import block_inflate as BI

    if not stream:
        raise PallasDecodeError("empty stream")
    out = bytearray()
    offs = 0
    nbits = len(stream) * 8
    for _ in range(MAX_BLOCKS):
        if offs >= nbits:
            raise PallasDecodeError("stream ends before BFINAL block")
        bfinal = (stream[offs >> 3] >> (offs & 7)) & 1
        o, produced, err, end_bit = BI.inflate_blocks(stream, [offs],
                                                      device=device)
        if err[0]:
            raise PallasDecodeError(f"block at bit {offs}: kernel error")
        out += o[0, :produced[0]].tobytes()
        offs = int(end_bit[0])
        if bfinal:
            return bytes(out)
    raise PallasDecodeError("too many blocks")
