"""Host-side bit-level stream assembly: joins encoded segments at
arbitrary bit offsets (the host half of the seam the reference library
implements serially in ``Bitstream::copyBitstream`` and ``BitFile``).

Port of deflate_tpu/runtime/stitch.py.  ``stitch_segments`` runs the
native ``dt_stitch`` (native/inflate.cpp); ``stitch_segments_plain`` is
the reference's numpy loop, kept for the tests.
"""
from __future__ import annotations

import numpy as np


def _u32(w) -> np.ndarray:
    """Encoder words as uint32: int32 words (the port's encoder) by a
    view of the same bits, not a value conversion."""
    w = np.asarray(w)
    return w.view(np.uint32) if w.dtype == np.int32 else w


def stitch_segments(segments) -> tuple[np.ndarray, int]:
    """Concatenate [(words int32 or uint32, nbits), ...] at bit
    granularity.  Returns (words uint32, total_bits).  Bits past nbits in
    each segment's last word must be zero (the encoder's are)."""
    from deflate_tpu_torch import native

    return native.stitch([(_u32(w), nb) for w, nb in segments])


def stitch_segments_plain(segments) -> tuple[np.ndarray, int]:
    """stitch_segments by a numpy loop over the segments."""
    total = sum(int(nb) for _, nb in segments)
    out = np.zeros(total // 32 + 2, dtype=np.uint32)
    off = 0
    for w, nb in segments:
        nb = int(nb)
        if nb == 0:
            continue
        nwords = (nb + 31) // 32
        w = np.asarray(_u32(w)[:nwords], dtype=np.uint32)
        base, s = off >> 5, off & 31
        if s == 0:
            out[base:base + nwords] |= w
        else:
            sh = (w << np.uint32(s)).astype(np.uint32)
            carry = (w >> np.uint32(32 - s)).astype(np.uint32)
            out[base:base + nwords] |= sh
            out[base + 1:base + 1 + nwords] |= carry
        off += nb
    return out, total


def words_to_bytes(words: np.ndarray, nbits: int) -> bytes:
    """The first ceil(nbits / 8) bytes of little-endian 32-bit words."""
    nbytes = (nbits + 7) // 8
    return np.ascontiguousarray(words).view(np.uint8)[:nbytes].tobytes()
