"""The benchmark's plain RFC 1951 decoder: the reference that judges what
the port writes.

Written for this benchmark from RFC 1951 alone; it imports nothing of the
program.  Besides the bytes, it records each block's bit span and output
size, and each block's entry phases: for every 64-bit chunk of a Huffman
block's symbol data (the bits after its header), the bit phase of the
first symbol (literal, length-distance pair, or end-of-block) that starts
in that chunk.  Those are what a manifest states, so the benchmark works
them out again from the stream instead of trusting the program's.

Pure Python, table-driven: one table lookup per code, the tables filled
by strided slice assignment, ~1 µs a symbol.
"""
from __future__ import annotations

import dataclasses

_LEN_BASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35,
             43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258]
_LEN_EXTRA = [0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5] * 4 + [0]
_DIST_BASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
              257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193,
              12289, 16385, 24577]
_DIST_EXTRA = [0, 0, 0, 0] + [i // 2 for i in range(2, 28)]
_CL_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1,
             15]
NO_SYMBOL = 255        # an entry phase where no symbol starts


class StreamError(ValueError):
    """The stream breaks RFC 1951."""


@dataclasses.dataclass
class Block:
    bit_offset: int        # first bit of the block header
    bit_len: int           # header through end-of-block (or stored bytes)
    out_len: int
    btype: int
    phases: bytes          # entry phase per 64-bit chunk; b"" when stored


def _table(lengths: list[int]):
    """Lookup table for canonical codes of these lengths: index the next
    `maxlen` stream bits (LSB first), get symbol << 4 | code length."""
    maxlen = max(lengths, default=0)
    if maxlen == 0:
        return [], 0
    count = [0] * 16
    for n in lengths:
        count[n] += 1
    count[0] = 0
    code, nxt = 0, [0] * 16
    for n in range(1, 16):
        code = (code + count[n - 1]) << 1
        nxt[n] = code
    left = 1
    for n in range(1, 16):
        left = (left << 1) - count[n]
        if left < 0:
            raise StreamError("oversubscribed code")
    size = 1 << maxlen
    table = [-1] * size
    for sym, n in enumerate(lengths):
        if n == 0:
            continue
        c = nxt[n]
        nxt[n] += 1
        rev = int(format(c, f"0{n}b")[::-1], 2)
        step = 1 << n
        table[rev::step] = [(sym << 4) | n] * ((size - rev + step - 1) // step)
    return table, maxlen


_FIXED = None


def _fixed():
    global _FIXED
    if _FIXED is None:
        lit = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
        _FIXED = (_table(lit), _table([5] * 30))
    return _FIXED


def inflate(stream: bytes, want_phases: bool = False,
            max_out: int | None = None):
    """Decode a whole raw DEFLATE stream: (bytes, [Block]).  Raises
    StreamError when the stream breaks RFC 1951, ends early, or would
    decode to more than max_out bytes."""
    data = stream
    nbytes = len(data)
    limit = (1 << 62) if max_out is None else max_out
    out = bytearray()
    blocks: list[Block] = []
    buf = 0            # bit buffer, LSB = next stream bit
    cnt = 0            # bits in buf
    ip = 0             # next byte of data to load

    while True:
        start = 8 * ip - cnt
        out0 = len(out)
        while cnt < 3:
            if ip >= nbytes:
                raise StreamError("stream ends inside a block header")
            buf |= data[ip] << cnt
            ip += 1
            cnt += 8
        final = buf & 1
        btype = (buf >> 1) & 3
        buf >>= 3
        cnt -= 3
        if btype == 0:
            buf >>= cnt & 7
            cnt -= cnt & 7
            while cnt < 32:
                if ip >= nbytes:
                    raise StreamError("stream ends inside a stored header")
                buf |= data[ip] << cnt
                ip += 1
                cnt += 8
            ln, nln = buf & 0xFFFF, (buf >> 16) & 0xFFFF
            buf >>= 32
            cnt -= 32
            if ln != nln ^ 0xFFFF:
                raise StreamError("stored length check fails")
            # whole bytes left in buf go first
            while cnt >= 8 and ln:
                out.append(buf & 0xFF)
                buf >>= 8
                cnt -= 8
                ln -= 1
            if ip + ln > nbytes:
                raise StreamError("stream ends inside a stored block")
            out += data[ip:ip + ln]
            ip += ln
            if len(out) > limit:
                raise StreamError("output exceeds its bound")
            blocks.append(Block(start, 8 * ip - cnt - start, len(out) - out0,
                                0, b""))
        elif btype == 3:
            raise StreamError("reserved block type")
        else:
            if btype == 1:
                (lt, lbits), (dt, dbits) = _fixed()
            else:
                while cnt < 14:
                    if ip >= nbytes:
                        raise StreamError("stream ends inside a header")
                    buf |= data[ip] << cnt
                    ip += 1
                    cnt += 8
                hlit = (buf & 31) + 257
                hdist = ((buf >> 5) & 31) + 1
                hclen = ((buf >> 10) & 15) + 4
                buf >>= 14
                cnt -= 14
                cl = [0] * 19
                for i in range(hclen):
                    while cnt < 3:
                        if ip >= nbytes:
                            raise StreamError("stream ends inside a header")
                        buf |= data[ip] << cnt
                        ip += 1
                        cnt += 8
                    cl[_CL_ORDER[i]] = buf & 7
                    buf >>= 3
                    cnt -= 3
                ct, cbits = _table(cl)
                if cbits == 0:
                    raise StreamError("empty code-length code")
                lens: list[int] = []
                while len(lens) < hlit + hdist:
                    while cnt < 16:
                        buf |= (data[ip] if ip < nbytes else 0) << cnt
                        ip += 1
                        cnt += 8
                    e = ct[buf & ((1 << cbits) - 1)]
                    if e < 0:
                        raise StreamError("bad code-length code")
                    buf >>= e & 15
                    cnt -= e & 15
                    sym = e >> 4
                    if sym < 16:
                        lens.append(sym)
                        continue
                    if sym == 16:
                        if not lens:
                            raise StreamError("repeat with no previous length")
                        rep, val = 3 + (buf & 3), lens[-1]
                        buf >>= 2
                        cnt -= 2
                    elif sym == 17:
                        rep, val = 3 + (buf & 7), 0
                        buf >>= 3
                        cnt -= 3
                    else:
                        rep, val = 11 + (buf & 127), 0
                        buf >>= 7
                        cnt -= 7
                    lens += [val] * rep
                if len(lens) > hlit + hdist:
                    raise StreamError("code lengths overrun")
                if lens[256] == 0:
                    raise StreamError("no end-of-block code")
                lt, lbits = _table(lens[:hlit])
                dt, dbits = _table(lens[hlit:])
            lmask = (1 << lbits) - 1
            dmask = (1 << dbits) - 1
            tok0 = 8 * ip - cnt                 # first bit of the symbols
            phases = bytearray()
            nxt = tok0                          # next chunk's first bit
            while True:
                if cnt < 48:
                    if ip + 8 <= nbytes:
                        buf |= int.from_bytes(data[ip:ip + 6], "little") << cnt
                        ip += 6
                        cnt += 48
                    else:
                        while cnt < 48:
                            buf |= (data[ip] if ip < nbytes else 0) << cnt
                            ip += 1
                            cnt += 8
                if want_phases:
                    p = 8 * ip - cnt
                    if p >= nxt:
                        while nxt + 64 <= p:            # chunk with no start
                            phases.append(NO_SYMBOL)
                            nxt += 64
                        phases.append(p - nxt)
                        nxt += 64
                e = lt[buf & lmask]
                if e < 0:
                    raise StreamError("bad literal/length code")
                buf >>= e & 15
                cnt -= e & 15
                sym = e >> 4
                if sym < 256:
                    out.append(sym)
                    continue
                if sym == 256:
                    break
                sym -= 257
                if sym >= 29:
                    raise StreamError("bad length symbol")
                eb = _LEN_EXTRA[sym]
                length = _LEN_BASE[sym] + (buf & ((1 << eb) - 1))
                buf >>= eb
                cnt -= eb
                if dbits == 0:
                    raise StreamError("match with no distance code")
                e = dt[buf & dmask]
                if e < 0 or (e >> 4) >= 30:
                    raise StreamError("bad distance code")
                buf >>= e & 15
                cnt -= e & 15
                sym = e >> 4
                eb = _DIST_EXTRA[sym]
                dist = _DIST_BASE[sym] + (buf & ((1 << eb) - 1))
                buf >>= eb
                cnt -= eb
                n = len(out)
                if dist > n:
                    raise StreamError("distance before the start")
                if n > limit:
                    raise StreamError("output exceeds its bound")
                if dist >= length:
                    out += out[n - dist:n - dist + length]
                else:
                    seg = out[n - dist:]
                    out += (seg * (length // dist + 1))[:length]
            if 8 * ip - cnt > 8 * nbytes:
                raise StreamError("stream ends inside a block")
            blocks.append(Block(start, 8 * ip - cnt - start, len(out) - out0,
                                btype, bytes(phases)))
        if final:
            break
    return bytes(out), blocks
