"""Host-side stream assembly helpers."""
from __future__ import annotations

import numpy as np


def words_to_bytes(words: np.ndarray, nbits: int) -> bytes:
    """The first ceil(nbits / 8) bytes of little-endian 32-bit words."""
    nbytes = (nbits + 7) // 8
    return np.ascontiguousarray(words).view(np.uint8)[:nbytes].tobytes()
