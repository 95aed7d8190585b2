"""The benchmark's plain range read: output bytes [start, end) of a
stream whose blocks decode independently, from the blocks that cover the
range alone.

The run of blocks that covers the range is cut from the stream at their
bit offsets, the last block's BFINAL bit is set so that the benchmark's
decoder (reference/inflate.py) stops after it, and a fixed-code block of
j literals goes in front, so that the run keeps its bit phase in a byte
(a stored block's padding depends on it).  The run's output, less the j
literals, is sliced to the range.  Plain Python; it imports nothing of
the program.
"""
from __future__ import annotations

from codecbench.reference.inflate import inflate

FILL = 200             # the front block's literal: a 9-bit fixed code


def cover(blocks, start: int, end: int):
    """(i0, i1, base): blocks[i0:i1] are those whose output overlaps
    [start, end), base the output offset of blocks[i0]."""
    i0 = i1 = base = None
    pos = 0
    for i, (_, _, out_len) in enumerate(blocks):
        if pos < end and pos + out_len > start:
            if i0 is None:
                i0, base = i, pos
            i1 = i + 1
        pos += out_len
    return i0, i1, base


def front(j: int) -> tuple[int, int]:
    """(bits, count): a fixed-code block, BFINAL 0, of j literals FILL and
    its end-of-block, LSB first as RFC 1951 sends it."""
    bits, n = 0b010, 3                  # BFINAL 0, BTYPE 01
    code = 0b110010000 + FILL - 144     # Huffman codes go top bit first
    for _ in range(j):
        for k in range(9):
            bits |= ((code >> (8 - k)) & 1) << n
            n += 1
    return bits, n + 7                  # end-of-block: code 0000000


def decode_range(stream: bytes, blocks, start: int, end: int) -> bytes:
    """Output bytes [start, end) of `stream`, whose blocks are `blocks`:
    (bit_offset, bit_len, out_len) of every block, in stream order."""
    end = min(end, sum(b[2] for b in blocks))
    if start >= end:
        return b""
    i0, i1, base = cover(blocks, start, end)
    first = blocks[i0][0]
    last_off, last_len, _ = blocks[i1 - 1]
    run = int.from_bytes(stream[first // 8:-(-(last_off + last_len) // 8)],
                         "little") >> (first % 8)
    run |= 1 << (last_off - first)      # BFINAL of the run's last block
    j = (first - 2) % 8                 # 10 + 9 j bits: first's phase
    bits, n = front(j)
    nbits = n + last_off + last_len - first
    data = (bits | run << n).to_bytes(-(-nbits // 8) + 1, "little")
    out, _ = inflate(data, max_out=j + sum(b[2] for b in blocks[i0:i1]))
    return out[j + start - base:j + end - base]
