"""Shared pieces of the deflate_tpu_torch tests (tests/test_torch_*.py).

Each test feeds one numpy input through the JAX reference (deflate_tpu,
on the CPU, Pallas kernels in interpret mode) and through its port, and
compares integer outputs exactly.  Tests marked ``cuda`` hold a CUDA
kernel against its plain version and skip without a card.
"""
from __future__ import annotations

import os
import sys
import zlib

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench import make_corpus  # noqa: E402
from deflate_tpu_torch.ops import wave as W  # noqa: E402
from deflate_tpu_torch.ops.pack import NPK, OUTW, TILE  # noqa: E402
from deflate_tpu_torch.utils import tables as T  # noqa: E402

# test files run in parallel worker processes; keep each to a few threads
torch.set_num_threads(2)

BLOCK = 32768


def corpus(nblocks: int, seed: int = 42) -> bytes:
    """The benchmark corpus at nblocks x 32 KiB (text, repeats, words,
    random quarters)."""
    return make_corpus(np.random.default_rng(seed), nblocks * BLOCK)


def nine_blocks() -> bytes:
    """294,412 bytes, 9 blocks: six blocks of word text (words from
    default_rng(12)), then random bytes from the same generator, which
    the encoder stores (3 stored, 6 dynamic blocks at level 2)."""
    from chip_smoke import word_text

    rng = np.random.default_rng(12)
    return word_text(rng, 6 * BLOCK) + bytes(
        rng.integers(0, 256, 294412 - 6 * BLOCK, dtype=np.uint8))


def past_64_blocks() -> bytes:
    """65 blocks, 2,099,152 bytes: 64 blocks of word text (words from
    default_rng(64)) and a last block of 2,000 random bytes, which the
    encoder stores.  At level 1 the first 64 blocks end at bit phase 4,
    so the stored block's byte-align padding depends on the phase
    carried across compress's 64 | 1 segment boundary."""
    from chip_smoke import word_text

    rng = np.random.default_rng(64)
    return word_text(rng, 64 * BLOCK) + bytes(
        rng.integers(0, 256, 2000, dtype=np.uint8))


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def jax_native_lib(attempts: int = 6):
    """deflate_tpu's native library, loaded, for a test that compares
    against a JAX-package path that needs it (``skeleton``,
    ``skeleton_plan``, ``decompress``).

    ``deflate_tpu.native.lib()`` runs ``make`` in every process and
    remembers a failure for the life of the process; the Makefile links
    the library in place, so test workers that start together on a fresh
    checkout can see a failed ``make`` or a half-written file.  Here the
    load is serialised across processes by a lock file, and a remembered
    failure is cleared and tried again after a short sleep.  Fails the
    test (never skips) if the library still does not load."""
    import fcntl
    import tempfile
    import time

    from deflate_tpu import native as JN

    last = None
    lock = os.path.join(tempfile.gettempdir(), "deflate_tpu_native.lock")
    with open(lock, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            for i in range(attempts):
                try:
                    L = JN.lib()
                except AttributeError as e:   # a library missing symbols
                    L, last = None, e
                if L is not None:
                    return L
                JN._lib, JN._tried = None, False
                time.sleep(0.25 * (i + 1))
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    pytest.fail(f"deflate_tpu's native library ({JN._SO}) did not load "
                f"after {attempts} attempts (make -C {JN._DIR}): {last}")


def np_i32(x) -> np.ndarray:
    """A torch or JAX array as a numpy int32 array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.int32)
    return np.asarray(x).astype(np.int32)


def assert_same(got, want, what: str = "") -> None:
    g, w = np_i32(got), np_i32(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    bad = np.argwhere(g != w)
    assert len(bad) == 0, (what, len(bad), bad[:5].tolist(),
                           g[tuple(bad[0])], w[tuple(bad[0])])


NM = 11264                  # match-record slots per block


def monotone_instance(rng, B, L, left):
    """Random routing instance: compaction (left) or spreading (right),
    two payloads, destinations strictly increasing."""
    delta = np.full((B, L), -1, np.int32)
    for b in range(B):
        occ = np.sort(rng.choice(L, size=int(rng.integers(1, L // 3)),
                                 replace=False))
        if left:
            dest = np.arange(len(occ))
        else:
            dest = occ + np.sort(rng.integers(0, 4, len(occ)).cumsum())
            keep = dest < L
            occ, dest = occ[keep], dest[keep]
        delta[b, occ] = np.abs(dest - occ)
    pays = [rng.integers(-2**31, 2**31, (B, L)).astype(np.int32)
            for _ in range(2)]
    return pays, delta


# K3 cases: (id, payloads P, left, B, L, rounds, kind).  "bounded":
# non-decreasing deltas below 2**rounds with strictly increasing
# destinations, plus slots whose delta is a multiple of 2**rounds (not
# routed), and row 0 without an element; "compact": the encoder's packet
# compaction (live lanes of the first 32769 to their rank, NPK lanes).
# The longest row is stage D's at the largest bucket (W64 4224 x CCAP).
ROUTE_CASES = [
    ("p1_left_odd_L", 1, True, 3, 3001, 12, "bounded"),
    ("p2_right_odd_L", 2, False, 3, 3001, 12, "bounded"),
    ("p3_left_unrouted", 3, True, 3, 4096, 9, "bounded"),
    ("p3_right_unrouted", 3, False, 3, 4096, 9, "bounded"),
    ("p1_right_L1024", 1, False, 2, 1024, 10, "bounded"),
    ("p3_packets_npk", 3, True, 2, 33 * 1024, 16, "compact"),
    ("p2_left_longest_row", 2, True, 2, 4224 * 16, 17, "bounded"),
]


def route_case(seed, P, left, B, L, rounds, kind):
    """Payloads (P int32 [B, L]) and delta int32 [B, L] of a ROUTE_CASES
    entry."""
    rng = np.random.default_rng(seed)
    delta = np.full((B, L), -1, np.int64)
    cap = (1 << rounds) - 1
    for b in range(1, B):
        if kind == "compact":
            live = np.nonzero(rng.random(32769) < 0.3)[0]
            delta[b, live] = live - np.arange(len(live))
            continue
        occ = np.sort(rng.choice(L, size=int(rng.integers(1, L // 2)),
                                 replace=False))
        gaps = np.diff(occ)
        # delta_{i+1} - delta_i < occ_{i+1} - occ_i keeps leftward
        # destinations strictly increasing; rightward ones always are
        inc = rng.integers(0, np.maximum(gaps, 1)) if left else \
            rng.integers(0, 3, len(gaps))
        d0 = int(rng.integers(0, min(occ[0], cap) + 1)) if left else \
            int(rng.integers(0, 4))
        d = np.minimum(np.concatenate([[d0], d0 + np.cumsum(inc)]), cap)
        delta[b, occ] = d
        free = np.nonzero(delta[b] < 0)[0]
        far = rng.choice(free, size=min(len(free), 5), replace=False)
        delta[b, far] = rng.integers(1, 4, len(far)) << rounds
    pays = [rng.integers(-2**31, 2**31, (B, L)).astype(np.int32)
            for _ in range(P)]
    return pays, delta.astype(np.int32)


# K7 cases (pack_case); each holds offsets that do not decrease over
# [0, count), zero payloads past count and garbage offsets there
PACK_CASES = ["random_phases", "count_0_and_npk", "zero_piles",
              "tile_straddle", "wide_64", "past_outw"]


def _pack_row(rng, n, fixed=(), wmax=8, start=0, limit=None):
    """Offsets and widths of up to n packets from bit `start`: random
    fillers of 0..wmax bits, and the (offset, width) packets of `fixed`
    (ascending, not overlapping) exactly where they say, a filler
    closing each gap; cut before the first packet that ends past
    `limit` bits."""
    offs, widths, cur = [], [], start
    for o, w in list(fixed) + [(None, None)]:
        while len(offs) < n and (o is None or cur + wmax < o):
            fw = int(rng.integers(0, wmax + 1))
            offs.append(cur)
            widths.append(fw)
            cur += fw
        if o is None or len(offs) >= n:
            break
        if cur < o:
            offs.append(cur)
            widths.append(o - cur)
        offs += [o]
        widths += [w]
        cur = o + w
    o, w = np.asarray(offs[:n], np.int64), np.asarray(widths[:n], np.int64)
    if limit is not None:
        keep = int(np.searchsorted(o + w > limit, True))
        o, w = o[:keep], w[:keep]
    return o, w


def pack_case(name: str):
    """(counts int32 [B], off, lo, hi int32 [B, NPK]) of a PACK_CASES
    entry; payloads fill their widths (up to 64 bits: bits 32..63 in hi)
    with the top bit set."""
    rng = np.random.default_rng(PACK_CASES.index(name) + 70)
    rows = []                                     # (offsets, widths)
    if name == "random_phases":                   # 0-48 bits, every phase
        for n in (600, 17, 0, 595):
            w = rng.integers(0, 49, n)
            rows.append((np.cumsum(w) - w, w))
    elif name == "count_0_and_npk":
        w = np.where(rng.random(NPK) < 0.1, rng.integers(17, 49, NPK),
                     rng.integers(0, 6, NPK))
        rows = [([], []), (np.cumsum(w) - w, w)]
    elif name == "zero_piles":
        # a stored block's 3 header packets and 659 zero lanes; 658
        # zero-width lanes after a 17-bit preamble, then tokens; a pile
        # of 283 at the last word of tile 0, then tokens past it
        rows.append(([0, 3, 35] + [51] * 659, [3, 32, 16] + [0] * 659))
        o, w = _pack_row(rng, 3000, wmax=12, start=17)
        rows.append(([0] + [17] * 658 + list(o), [17] + [0] * 658 + list(w)))
        rows.append(_pack_row(rng, 6000, [(32 * (TILE - 1) + 9, 0)] * 283,
                              wmax=16))
    elif name == "tile_straddle":
        # for every tile boundary W0, a 48- or 64-bit packet from word
        # W0 - 2 (bits 20 and 1) or from W0 - 1 (bits 31 and 17), one
        # kind a row; then a row that ends with such a packet
        for word, bit, width in ((2, 20, 48), (1, 31, 48), (2, 1, 64),
                                 (1, 17, 64)):
            fixed = [(32 * (w0 - word) + bit, width)
                     for w0 in range(TILE, OUTW, TILE)]
            rows.append(_pack_row(rng, NPK, fixed, wmax=20,
                                  limit=32 * OUTW))
        # the row's last packet from word 2 TILE - 2 into the next tile
        last = 32 * (2 * TILE - 2) + 20
        o, w = _pack_row(rng, NPK, [(last, 48)], wmax=20, limit=last)
        rows.append((list(o) + [last], list(w) + [48]))
    elif name == "wide_64":                       # 33-64 bits, next at end
        for n in (900, 4100):
            w = rng.integers(33, 65, n)
            w[::7] = 64
            rows.append((np.cumsum(w) - w, w))
    elif name == "past_outw":
        # packets across word OUTW - 1 and past OUTW, the last ones
        # wholly beyond it
        base = 32 * (OUTW - 3)
        rows.append(_pack_row(rng, 20000, [
            (base + 7, 64), (base + 71, 64), (base + 135, 48),
            (base + 183, 40), (base + 300, 64)], wmax=40))
        rows.append(_pack_row(rng, 100, [(32 * (OUTW - 1) + 31, 33)],
                              start=32 * (OUTW - 1) - 200))
    else:
        raise KeyError(name)
    B = len(rows)
    counts = np.zeros(B, np.int32)
    off = rng.integers(0, 1 << 20, (B, NPK)).astype(np.int32)  # garbage
    val = np.zeros((B, NPK), np.uint64)
    for b, (o, w) in enumerate(rows):
        o, w = np.asarray(o, np.int64), np.asarray(w, np.uint64)
        counts[b] = n = len(o)
        off[b, :n] = o
        v = rng.integers(0, 1 << 63, n, dtype=np.uint64) * np.uint64(2) \
            + rng.integers(0, 2, n).astype(np.uint64)
        full = w >= 64
        mask = np.where(full, np.uint64(0),
                        (np.uint64(1) << np.minimum(w, np.uint64(63)))
                        - np.uint64(1))
        v = np.where(full, v, v & mask)
        top = np.where(w > 0, np.uint64(1) << (np.maximum(w, np.uint64(1))
                                               - np.uint64(1)), np.uint64(0))
        val[b, :n] = v | top
    lo = (val & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (val >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return counts, off, lo, hi


def pack_spill(counts, off, lo, hi) -> np.ndarray:
    """Per row, the OR of the live packets' shifted words at or past OUTW
    (the words the contract drops)."""
    B = len(counts)
    spill = np.zeros(B, np.uint64)
    for b in range(B):
        n = int(counts[b])
        o = off[b, :n].astype(np.int64)
        v = lo[b, :n].view(np.uint32).astype(object) \
            | (hi[b, :n].view(np.uint32).astype(object) << 32)
        for ob, vb in zip(o, v):
            shifted = vb << int(ob & 31)
            for k in range(3):
                if (ob >> 5) + k >= OUTW:
                    spill[b] |= np.uint64((shifted >> (32 * k)) & 0xFFFFFFFF)
    return spill.astype(np.uint32).view(np.int32)


def fill_case(B):
    """Every distance class (1, 2, 3 periodic; 4-8 overlapping; far),
    every word phase, short and long lengths (the reference's
    adversarial fill test)."""
    rng = np.random.default_rng(11)
    lit = rng.integers(-2**31, 2**31, (B, 8192), dtype=np.int64)
    lit = lit.astype(np.int32)
    rec0 = np.zeros((B, NM), np.int32)
    rec1 = np.zeros((B, NM), np.int32)
    nmatch = np.zeros(B, np.int32)
    cases = []
    o = 16
    for dist in (1, 2, 3, 4, 5, 6, 7, 8, 31, 509):
        for ln in (3, 4, 7, 15, 16, 17, 29, 258):
            for phase in range(4):
                cases.append((o + phase, ln, dist))
                o += ln + phase + 11
    per = len(cases) // B + 1
    for b in range(B):
        sub = cases[b * per:(b + 1) * per]
        for m, (o_, ln, d) in enumerate(sub):
            rec0[b, m] = (o_ & 0xFFFF) | ((ln - 3) << 16)
            rec1[b, m] = d
        nmatch[b] = len(sub)
    return lit, rec0, rec1, nmatch


def hist_case():
    """Rows of a foreign-stream plan in stream order for the ordered fill
    with history (K5): row 0 holds every distance class (fill_case),
    then short rows (300, 5, 7, 0, 3 bytes), a row whose first record
    reaches back across four of them, and a row with a match at the
    32 KiB maximum distance.  Returns (litwords [B, 8192], rec0, rec1
    [B, NM] raw records, nmatch [B], sizes [B]), int32."""
    rng = np.random.default_rng(17)
    sizes = np.array([32768, 300, 5, 7, 0, 3, 1001, 20001], np.int32)
    B = len(sizes)
    lit = rng.integers(-2**31, 2**31, (B, 8192), dtype=np.int64)
    lit = lit.astype(np.int32)
    rec0 = np.zeros((B, NM), np.int32)
    rec1 = np.zeros((B, NM), np.int32)
    nmatch = np.zeros(B, np.int32)
    _, r0, r1, nm = fill_case(1)
    rec0[0], rec1[0], nmatch[0] = r0[0], r1[0], nm[0]
    before = 0                       # output bytes before the row
    for b in range(1, B):
        before += int(sizes[b - 1])
        recs = []
        o = 0
        if b == 6:                   # back across rows 5, 4, 3, 2 into 1
            recs.append((0, 30, 25))
            o = 30
        if b == 7:                   # the largest distance
            recs.append((0, 258, 32768))
            o = 258
        while True:
            o += int(rng.integers(0, 4))             # literal gap
            ln = int(rng.integers(3, 40))
            if o + ln > sizes[b]:
                break
            dmax = min(32768, before + o)
            d = int(rng.choice([1, 2, 3, int(rng.integers(1, dmax + 1)),
                                dmax]))
            recs.append((o, ln, min(d, dmax)))
            o += ln
        for m, (o_, ln, d) in enumerate(recs):
            rec0[b, m] = o_ | ((ln - 3) << 16)
            rec1[b, m] = d
        nmatch[b] = len(recs)
    return lit, rec0, rec1, nmatch, sizes


def pack_fields(fields) -> bytes:
    """(value, nbits) fields, LSB-first, as bytes (4 zero bytes after)."""
    acc = nb = 0
    for v, n in fields:
        acc |= int(v) << nb
        nb += int(n)
    return acc.to_bytes(-(-nb // 8) + 4, "little")


def _fixed_code(sym: int):
    """The fixed-Huffman litlen code of sym as an LSB-first field."""
    if sym < 144:
        code, n = 0x30 + sym, 8
    elif sym < 256:
        code, n = 0x190 + sym - 144, 9
    elif sym < 280:
        code, n = sym - 256, 7
    else:
        code, n = 0xC0 + sym - 280, 8
    return int(format(code, f"0{n}b")[::-1], 2), n


def long_match_streams() -> dict:
    """Single self-contained blocks of long matches: "dist_1", zlib's
    block of 258-byte matches at distance 1 (127 of them), and
    "dist_32510", a hand-built fixed-Huffman block of 32510 random
    literals and one 258-byte match at distance 32768 - 258 (past
    zlib's longest distance, 32506).  Each decodes to 32768 bytes."""
    rng = np.random.default_rng(9)
    c = zlib.compressobj(9, zlib.DEFLATED, -15, 9)
    near = c.compress(b"z" * 32768) + c.flush()
    dist, length = 32768 - 258, 258
    head = rng.integers(0, 256, dist, dtype=np.uint8)
    li = max(i for i in range(29) if T.LENGTH_BASE[i] <= length)
    di = max(i for i in range(30) if T.DIST_BASE[i] <= dist)
    fields = [(1, 1), (1, 2)] + [_fixed_code(int(v)) for v in head]
    fields += [_fixed_code(257 + li),
               (length - int(T.LENGTH_BASE[li]), int(T.LENGTH_EXTRA[li])),
               (int(format(di, "05b")[::-1], 2), 5),
               (dist - int(T.DIST_BASE[di]), int(T.DIST_EXTRA[di])),
               _fixed_code(256)]
    return {"dist_1": near, "dist_32510": pack_fields(fields)}


def random_code(rng, nsym: int, ncodes: int, must=()):
    """Lengths of a random complete prefix code of ncodes symbols (one
    of them each of `must`), depths up to 15."""
    depths = [0]
    while len(depths) < ncodes:
        i = int(rng.choice([k for k, d in enumerate(depths) if d < 15]))
        d = depths.pop(i) + 1
        depths += [d, d]
    rest = [s for s in range(nsym) if s not in must]
    syms = list(must) + list(rng.choice(rest, ncodes - len(must),
                                        replace=False))
    lens = np.zeros(nsym, np.int64)
    lens[syms] = rng.permutation(depths)
    return lens


def md_rows(codes) -> dict:
    """Stage-A md rows (wave.MD_KEYS, int32 [B, 16] each) of (litlen,
    distance) code length lists, one pair a block."""
    rows = {k: [] for k in W.MD_KEYS}
    for lit, dist in codes:
        for pre, m in (("l_", W._canon_meta(lit, True)),
                       ("d_", W._canon_meta(dist, False))):
            for k in ("lim", "first", "meta", "mask"):
                if pre + k in rows:
                    rows[pre + k].append(W._u32(m[k]))
    return {k: np.stack(v) for k, v in rows.items()}


def random_code_case(rng, B: int, W64: int):
    """Stage-A operands (windows int32 [B, 2*W64+4], hints int32 [B, W64],
    md rows): random words and hints under random complete codes; the
    last block's distance tree is one 1-bit code (half its distance
    peeks find no code)."""
    codes = []
    for b in range(B):
        lit = random_code(rng, 286, int(rng.integers(20, 200)),
                          must=(256, 257, 270, 284))
        dist = np.zeros(30, np.int64)
        if b == B - 1:
            dist[int(rng.integers(0, 30))] = 1
        else:
            dist = random_code(rng, 30, int(rng.integers(2, 31)))
        codes.append((lit, dist))
    words = rng.integers(-2**31, 2**31, (B, 2 * W64 + 4), dtype=np.int64)
    hints = rng.integers(0, 64, (B, W64)).astype(np.int32)
    hints[rng.random((B, W64)) < 0.1] = W.HINT_NONE
    return words.astype(np.int32), hints, md_rows(codes)


def long_code_case(rng, B: int, W64: int):
    """Stage-A operands whose litlen and distance codes have depths 1 to
    15 and 15 (the longest 15 bits), under words of 90% one bits, which
    reach the long codes often: most peeks miss a table of 10-12 bits."""
    chain = list(range(1, 16)) + [15]
    lit = np.zeros(286, np.int64)
    lit[[65, 256, 257, 97, 262, 100, 270, 110, 280, 120, 284, 66, 258,
         285, 67, 68]] = chain
    dist = np.zeros(30, np.int64)
    dist[[0, 29, 4, 20, 8, 13, 1, 27, 5, 16, 2, 24, 10, 3, 18, 6]] = chain
    bits = rng.random((B, (2 * W64 + 4) * 32)) < 0.9
    words = np.packbits(bits, axis=1, bitorder="little").view(np.int32)
    hints = rng.integers(0, 64, (B, W64)).astype(np.int32)
    return words, hints, md_rows([(lit, dist)] * B)


def pack_fields(fields) -> bytes:
    """(value, nbits) fields, LSB first, as bytes."""
    acc = n = 0
    for v, k in fields:
        acc |= (v & ((1 << k) - 1)) << n
        n += k
    return acc.to_bytes((n + 7) // 8, "little")


def dynamic_header(hlit: int, hdist: int, cl_lens: dict, ops) -> bytes:
    """A final dynamic block's header (HLIT field hlit - 257, ...), a CL
    code of cl_lens {symbol: length} and CL ops [(symbol, extra)]."""
    lens = np.zeros(19, np.int64)
    for sym, ln in cl_lens.items():
        lens[sym] = ln
    order = list(T.CL_ORDER)
    hclen = max(4, max(order.index(s) for s in cl_lens) + 1)
    code, nxt = {}, 0
    for ln in range(1, 8):                       # canonical codes
        for sym in range(19):
            if lens[sym] == ln:
                code[sym] = int(format(nxt, f"0{ln}b")[::-1], 2)
                nxt += 1
        nxt <<= 1
    extra = {16: 2, 17: 3, 18: 7}
    fields = [(1, 1), (2, 2), (hlit - 257, 5), (hdist - 1, 5),
              (hclen - 4, 4)]
    fields += [(int(lens[order[i]]), 3) for i in range(hclen)]
    for sym, ev in ops:
        fields.append((code[sym], int(lens[sym])))
        if sym in extra:
            fields.append((ev, extra[sym]))
    return pack_fields(fields)


# ---- multi-rank runs (parallel/): gloo ranks in spawned processes ------
from chip_smoke import corrupt_block3  # noqa: E402,F401

RANK_TIMEOUT = 120          # seconds each spawned rank may take


def mk_blocks(B, rng, fill=1.0):
    """tests/test_mesh.py's _mk_blocks: B blocks of low-alphabet text,
    random bytes and a repeated 97-byte pattern in turn, block i holding
    32768 * fill - 17 * i bytes.  Returns (blocks uint8 [B, 32768],
    blens int32 [B])."""
    blocks = np.zeros((B, BLOCK), np.uint8)
    blens = np.zeros((B,), np.int32)
    for i in range(B):
        k = max(1, int(BLOCK * fill) - 17 * i)
        if i % 3 == 0:
            blocks[i, :k] = rng.integers(97, 105, k, dtype=np.uint8)
        elif i % 3 == 1:
            blocks[i, :k] = rng.integers(0, 256, k, dtype=np.uint8)
        else:
            pat = rng.integers(0, 256, 97, dtype=np.uint8)
            blocks[i, :k] = np.tile(pat, k // 97 + 1)[:k]
        blens[i] = k
    return blocks, blens


def _rank_main(tmp: str, world: str, rank: str, job: str,
               port: str) -> None:
    """One spawned rank: join the world (a FileStore in tmp, or the port's
    distributed.init at 127.0.0.1:port when port is not "0"), run
    JOBS[job] on the pickled arguments, pickle its result or exception."""
    import pickle

    import torch.distributed as dist

    torch.set_num_threads(1)
    world, rank = int(world), int(rank)
    with open(os.path.join(tmp, f"{job}.args"), "rb") as f:
        args = pickle.load(f)
    if port != "0":
        from deflate_tpu_torch.parallel import distributed as DD

        DD.init(f"127.0.0.1:{port}", world, rank, device="cpu")
    else:
        store = dist.FileStore(os.path.join(tmp, f"{job}.store"), world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
    try:
        res = {"result": JOBS[job](*args)}
    except Exception as e:                       # noqa: BLE001
        res = {"error": f"{type(e).__name__}: {e}"}
    with open(os.path.join(tmp, f"{job}.{rank}.out"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


def run_ranks(tmp_path, world: int, job: str, *args, port: int = 0,
              timeout: float = RANK_TIMEOUT):
    """Run JOBS[job](*args) on `world` gloo ranks, one spawned process
    each, joined through a FileStore in tmp_path (or through
    distributed.init on 127.0.0.1:port).  Each process is killed, and the
    test fails, when it outlives its timeout: a rank left hanging in a
    collective fails this test, not the suite.  Returns each rank's
    result in rank order."""
    import pickle
    import subprocess
    import time

    tmp = str(tmp_path)
    with open(os.path.join(tmp, f"{job}.args"), "wb") as f:
        pickle.dump(args, f)
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import torch_helpers as H; H._rank_main(*sys.argv[3:])")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    tests = os.path.join(ROOT, "tests")
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, ROOT, tests, tmp, str(world), str(r),
         job, str(port)], cwd=tmp, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    logs = []
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(
                    timeout=max(1.0, t0 + timeout - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {r} of {world} ({job}) outlived its "
                            f"{timeout} s timeout (a hang)")
            logs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (rc, out, err) in enumerate(logs):
        assert rc == 0, f"rank {r} of {world} ({job}) exited {rc}:\n{err}"
        with open(os.path.join(tmp, f"{job}.{r}.out"), "rb") as f:
            res = pickle.load(f)
        assert "result" in res, f"rank {r} of {world} ({job}): {res}"
        results.append(res["result"])
    return results


def _raises(fn):
    """The exception class name fn raises, or None."""
    try:
        fn()
    except Exception as e:                       # noqa: BLE001
        return type(e).__name__
    return None


def job_encode(data, blocks, blens):
    """compress_mesh of data at levels 0 and 2 (with a mesh, and through
    CodecConfig's level and mesh_axis without one), and encode_mesh of
    this rank's shard of blocks at phase0 5."""
    from deflate_tpu_torch.parallel import mesh as PM
    from deflate_tpu_torch.utils.config import CodecConfig

    mesh = PM.make_mesh(device="cpu")
    me, ndev = mesh.get_local_rank(), mesh.size()
    Bl = len(blens) // ndev
    sl = slice(me * Bl, (me + 1) * Bl)
    out = {"world": ndev, "axis": mesh.mesh_dim_names}
    for level in (0, 2):
        out[f"compress{level}"] = PM.compress_mesh(data, level, mesh)
        w, total = PM.encode_mesh(
            torch.from_numpy(blocks[sl]), torch.from_numpy(blens[sl]),
            torch.ones(Bl, dtype=torch.bool), len(blens) - 1, level, mesh,
            phase0=5)
        out[f"phase5_{level}"] = (w.numpy(), total)
    out["config"] = PM.compress_mesh(
        data, 2, config=CodecConfig(level=0, mesh_axis="blocks"))
    return out


def job_decode(stream, man_bytes, hstream, hman_bytes):
    """decompress_mesh of a v2 manifest (with a spy on the wave route)
    and of a hintless one, then of corrupted copies of both streams."""
    from deflate_tpu_torch.parallel import mesh as PM
    from deflate_tpu_torch.runtime.manifest import Manifest

    mesh = PM.make_mesh(device="cpu")
    man, hman = Manifest.from_bytes(man_bytes), Manifest.from_bytes(
        hman_bytes)
    hits = []
    real = PM.decompress_mesh_wave
    PM.decompress_mesh_wave = lambda *a, **k: hits.append(1) or real(*a, **k)
    try:
        wave = PM.decompress_mesh(stream, man, mesh)
        n_wave = len(hits)
        scan = PM.decompress_mesh(hstream, hman, mesh)
        n_scan = len(hits) - n_wave
    finally:
        PM.decompress_mesh_wave = real
    return {"wave": wave, "scan": scan, "wave_route_calls": (n_wave, n_scan),
            "corrupt_wave": _raises(lambda: PM.decompress_mesh(
                corrupt_block3(stream, man), man, mesh)),
            "corrupt_scan": _raises(lambda: PM.decompress_mesh(
                corrupt_block3(hstream, hman), hman, mesh))}


def job_distributed(data):
    """compress_distributed on the global mesh of a world joined by
    distributed.init."""
    from deflate_tpu_torch.parallel import distributed as DD

    mesh = DD.global_mesh()
    return {"world": mesh.size(), "device": mesh.device_type,
            "stream": DD.compress_distributed(data, level=2)}


def job_dryrun(world):
    """entry.dryrun_multichip over the world, on the CPU."""
    from deflate_tpu_torch import entry

    return entry.dryrun_multichip(world, device="cpu")


JOBS = {"encode": job_encode, "decode": job_decode,
        "distributed": job_distributed, "dryrun": job_dryrun}
