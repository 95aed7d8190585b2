"""RFC 1951 static tables as dense arrays.

The reference keeps these as linear-scan ``Range`` lists and switch statements
(`common.hpp:442-575` of the reference C++ library). The array-native
representation is dense base/extra arrays plus direct value->symbol lookup
tables so that every symbol mapping is a single gather — no scans, no
branches.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Length codes 257..285  (reference: generateLengthLookup, common.hpp:508-540)
# ---------------------------------------------------------------------------
# LENGTH_BASE[i] is the smallest match length encoded by litlen symbol 257+i.
LENGTH_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
     35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258],
    dtype=np.int32,
)
LENGTH_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
     3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0],
    dtype=np.int32,
)

# Direct lookup: match length (3..258) -> length-code index 0..28.
# Per RFC 1951, length 258 uses symbol 285 (base 258, 0 extra bits), even
# though symbol 284's base+extra range would also cover it.
_len2sym = np.zeros(259, dtype=np.int32)
for _i in range(28):
    _lo = LENGTH_BASE[_i]
    _hi = LENGTH_BASE[_i + 1]
    _len2sym[_lo:_hi] = _i
_len2sym[258] = 28
LENGTH_TO_CODE = _len2sym  # index with match length; add 257 for the symbol

# ---------------------------------------------------------------------------
# Distance codes 0..29  (reference: generateDistanceLookup, common.hpp:542-575)
# ---------------------------------------------------------------------------
DIST_BASE = np.array(
    [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
     257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145,
     8193, 12289, 16385, 24577],
    dtype=np.int32,
)
DIST_EXTRA = np.array(
    [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
     7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13],
    dtype=np.int32,
)

# Direct lookup: distance (1..32768) -> distance symbol 0..29.
_dist2sym = np.zeros(32769, dtype=np.int32)
for _i in range(29):
    _dist2sym[DIST_BASE[_i]:DIST_BASE[_i + 1]] = _i
_dist2sym[DIST_BASE[29]:] = 29
DIST_TO_CODE = _dist2sym  # index with distance 1..32768

# ---------------------------------------------------------------------------
# Fixed Huffman code lengths  (reference: generateFixedCodes common.hpp:442-482,
# generateFixedDistanceCodes common.hpp:484-495)
# ---------------------------------------------------------------------------
FIXED_LITLEN_LENGTHS = np.concatenate([
    np.full(144, 8, dtype=np.int32),   # 0-143   -> 8 bits
    np.full(112, 9, dtype=np.int32),   # 144-255 -> 9 bits
    np.full(24, 7, dtype=np.int32),    # 256-279 -> 7 bits
    np.full(8, 8, dtype=np.int32),     # 280-287 -> 8 bits
])
FIXED_DIST_LENGTHS = np.full(32, 5, dtype=np.int32)

# ---------------------------------------------------------------------------
# Code-length (CL) alphabet  (reference: permutation duplicated at
# deflate.hpp:571-591 and inflate.hpp:137-157)
# ---------------------------------------------------------------------------
CL_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32,
)
# Inverse permutation: CL_ORDER_INV[sym] = slot in the transmitted sequence.
CL_ORDER_INV = np.zeros(19, dtype=np.int32)
CL_ORDER_INV[CL_ORDER] = np.arange(19, dtype=np.int32)

# ---------------------------------------------------------------------------
# Global constants (reference: common.hpp:14, deflate.hpp:8-10)
# ---------------------------------------------------------------------------
BLOCK_SIZE = 32768          # one input chunk == one DEFLATE block (quirk Q1)
WINDOW_SIZE = 32768         # max back-reference distance
MAX_CODE_LEN = 15           # litlen / dist code length limit
MAX_CL_CODE_LEN = 7         # code-length alphabet limit
MIN_MATCH = 3
MAX_MATCH = 258
NUM_LITLEN = 288            # litlen alphabet size (286/287 reserved)
NUM_DIST = 32               # dist alphabet size (30/31 reserved)
NUM_CL = 19


def bit_reverse(value: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    """Reverse the low `nbits` bits of each value (numpy host version).

    Huffman codes are emitted MSB-first into the LSB-first bitstream
    (RFC 1951 §3.1.1; reference `flipBits` deflate.hpp:26-32).
    """
    v = np.asarray(value, dtype=np.uint32)
    v = ((v & 0x5555) << 1) | ((v >> 1) & 0x5555)
    v = ((v & 0x3333) << 2) | ((v >> 2) & 0x3333)
    v = ((v & 0x0F0F) << 4) | ((v >> 4) & 0x0F0F)
    v = ((v & 0x00FF) << 8) | ((v >> 8) & 0x00FF)
    n = np.asarray(nbits)
    return np.where(n > 0, v >> (16 - np.minimum(n, 16)), 0).astype(np.int32)
