"""Wavefront device decoder — the batch front end of ops/wave.py.

Port of deflate_tpu/models/wave_decoder.py.  Two entry points:

- ``inflate_wave_device`` / ``inflate_wave``: B independent blocks with
  hints (a manifest).  Header parse and window extraction on the host,
  span bucketing (one bucket per window size), stored blocks as a plain
  window copy, stages A-F (ops/wave.wave_decode) and the match fill
  (kernel K4), then reassembly in block order.  As in the reference,
  every bucket's operands travel to the device in one copy (one int32
  buffer, ``prepare_bucketed``), each bucket returns one [n, OW+2]
  result (``wave_decode_packed``), and the results come back in one
  copy.
- ``skeleton_plan`` + ``inflate_wave_planned``: any raw DEFLATE stream
  (foreign zlib/gzip output included).  The native skeleton walk cuts
  it into <= 32 KiB virtual blocks with hints; stages A-F run on groups
  of virtual blocks with synthetic stops, and the ordered match fill
  with a 32 KiB cross-block history (kernel K5) resolves them in stream
  order.
"""
from __future__ import annotations

import numpy as np
import torch

from deflate_tpu_torch._build import torch_device
from deflate_tpu_torch.ops import wave as W
from deflate_tpu_torch.ops import wave_fill as WF
from deflate_tpu_torch.utils import metrics
from deflate_tpu_torch.utils.bits import I32, srl

BUCKETS = (512, 1024, 1536, 2048, 2560, 3072, 3584, 4224)   # W64 sizes
MD_DEVICE_KEYS = W.MD_KEYS + ("l_litmask",)


def wave_decode_filled(nw, hints, sizes, md, W64: int, maxl: int = 15,
                       maxd: int = 15):
    """Stages A-F plus the match fill for one bucket.  Returns (filled
    words int32 [n, 8192], produced [n], err [n])."""
    litwords, rec0, rec1, nmatch, prod, err = W.wave_decode(
        nw, hints, sizes, md, W64, maxl=maxl, maxd=maxd)
    with metrics.span("decode.fill"):
        recs = WF.pack_fill_recs(rec0, rec1)
        return WF.fill_matches(litwords, recs, nmatch), prod, err


# ---- single-transfer call packing ----------------------------------------
# A bucket's 13 operand arrays (windows, hints, sizes, 10 metadata arrays)
# are packed into one int32 buffer on the host, every bucket's buffer is
# concatenated, and the whole goes to the device in one copy; each bucket
# slices its operands back out as views.
MD_KEYS9 = ("l_lim", "l_first", "l_base", "l_meta", "l_mask",
            "d_lim", "d_first", "d_base", "d_mask")


def _bucket_words(W64: int, n: int) -> int:
    return n * (2 * W64 + 4) + n * (W64 // 4) + n + n * 272


def _pack_bucket(nw, hsel, sizes, md, sel):
    """One contiguous int32 buffer: nw | hint bytes | sizes | md | litmask."""
    parts = [np.ascontiguousarray(nw, np.int32).ravel(),
             np.ascontiguousarray(hsel, np.uint8).view("<i4").ravel(),
             np.asarray(sizes, np.int32)]
    for k in MD_KEYS9:
        parts.append(np.ascontiguousarray(md[k][sel], np.int32).ravel())
    parts.append(np.ascontiguousarray(md["l_litmask"][sel],
                                      np.int32).ravel())
    return np.concatenate(parts)


def _unpack_bucket(packed, W64: int, n: int):
    """Views of one bucket's operands in its packed buffer; the hints
    are unpacked from their little-endian words into a new tensor."""
    c = 2 * W64 + 4
    o0 = n * c
    nw = packed[:o0].view(n, c)
    o1 = o0 + n * (W64 // 4)
    hw = packed[o0:o1].view(n, W64 // 4)
    hints = torch.stack([srl(hw, 8 * k) & 255 for k in range(4)],
                        2).reshape(n, W64)
    o2 = o1 + n
    sizes = packed[o1:o2]
    md = {}
    off = o2
    for k in MD_KEYS9:
        md[k] = packed[off:off + 16 * n].view(n, 16)
        off += 16 * n
    md["l_litmask"] = packed[off:off + 128 * n].view(n, 16, 8)
    return nw, hints, sizes, md


def wave_decode_packed(packed, W64: int, n: int, off: int = 0,
                       maxl: int = 15, maxd: int = 15):
    """wave_decode_filled over a packed operand buffer.

    packed: int32 tensor, possibly the shared all-buckets buffer, with
    this bucket at word offset off.  maxl/maxd: the bucket's max
    litlen/dist code lengths (stage A skips compare rounds past them).
    Returns ONE int32 [n, OW+2] tensor (filled words | produced | err),
    so that all buckets come back to the host in one copy."""
    packed = packed[off:off + _bucket_words(W64, n)]
    nw, hints, sizes, md = _unpack_bucket(packed, W64, n)
    filled, prod, e = wave_decode_filled(nw, hints, sizes, md, W64, maxl,
                                         maxd)
    return torch.cat([filled, prod[:, None].to(I32), e[:, None].to(I32)],
                     1)


def _common_prep(stream: bytes, bit_offsets, out_sizes, hints):
    """Header parse + stored/Huffman classification.  The stored blocks'
    window extraction is deferred (stored_fn)."""
    bit_offsets = np.asarray(bit_offsets, np.int64)
    out_sizes = np.asarray(out_sizes, np.int64)
    B = len(bit_offsets)
    md = W.parse_headers_host(stream, bit_offsets)
    if hints is None:
        hints, _ = W.hints_from_walk_host(stream, bit_offsets)
    hints = np.asarray(hints, np.uint8)

    # span upper bound from the next block's offset (blocks are dense)
    next_off = np.append(bit_offsets[1:], 8 * len(stream))
    span = np.maximum(next_off - md["data_start"], 0)

    err = np.asarray(md["hdr_err"]).astype(np.int64).copy()
    is_stored = md["btype"] == 0
    sidx = np.nonzero(is_stored & ~md["hdr_err"])[0]
    stored_fn = None
    if len(sidx):
        err[sidx] |= (md["stored_len"][sidx] != out_sizes[sidx])

        def stored_fn():
            nw = W.prepare_windows(stream, md["data_start"][sidx], 4096)
            return nw[:, :WF.OW]

    hidx_all = np.nonzero(~is_stored & ~md["hdr_err"])[0]
    overflow = span[hidx_all] > 64 * BUCKETS[-1]
    err[hidx_all[overflow]] = 1
    hidx_all = hidx_all[~overflow]
    return {"B": B, "md": md, "err": err, "sidx": sidx,
            "stored_fn": stored_fn, "out_sizes": out_sizes, "hints": hints,
            "hidx_all": hidx_all, "need": -(-span[hidx_all] // 64),
            "stream": stream}


def _iter_buckets(prep):
    """Yield (sel, packed numpy int32, W64, n, (maxl, maxd)) per
    non-empty span bucket.  The reference also yields npad, the row
    count padded to its TPU fill kernel's cell; K4 has no cell."""
    md = prep["md"]
    hints = prep["hints"]
    hidx_all, need = prep["hidx_all"], prep["need"]
    lens16 = np.arange(16)[None, :]
    cnt_l = md["l_lim"].astype(np.int64) - md["l_first"].astype(np.int64)
    cnt_d = md["d_lim"].astype(np.int64) - md["d_first"].astype(np.int64)
    for i, W64 in enumerate(BUCKETS):
        lo = BUCKETS[i - 1] if i else 0
        sel = hidx_all[(need <= W64) & (need > lo)]
        if not len(sel):
            continue
        nw = W.prepare_windows(prep["stream"], md["data_start"][sel], W64)
        hsel = np.full((len(sel), W64), W.HINT_NONE, np.uint8)
        hav = min(W64, hints.shape[1])
        hsel[:, :hav] = hints[sel][:, :hav]
        # the bucket's longest litlen / dist codes bound stage A's compare
        # rounds (longer rounds never hit); quantized to the reference's
        # tiers
        maxl = int(min(15, max(1, np.max(
            np.where(cnt_l[sel] > 0, lens16, 0)))))
        maxd = int(min(15, max(1, np.max(
            np.where(cnt_d[sel] > 0, lens16, 0)))))
        maxl = next(t for t in (10, 12, 15) if maxl <= t)
        maxd = next(t for t in (13, 15) if maxd <= t)
        packed = _pack_bucket(nw, hsel, prep["out_sizes"][sel], md, sel)
        yield sel, packed, W64, len(sel), (maxl, maxd)


def prepare_bucketed(stream: bytes, bit_offsets, out_sizes, hints=None,
                     device="cuda"):
    """Host prep: header parse, stored/Huffman split, span bucketing,
    window extraction, and one host-to-device copy of every bucket's
    operands.

    Returns (prep dict, calls), each call (sel, (buf, off), W64, n,
    (maxl, maxd)) ready for wave_decode_packed: buf is the shared
    operand buffer on `device`, off the bucket's word offset in it.
    prep["stored_words"] holds the stored blocks' windows (host numpy),
    or None."""
    dev = torch_device(device)
    with metrics.span("decode.headers"):
        prep = _common_prep(stream, bit_offsets, out_sizes, hints)
    with metrics.span("decode.windows"):
        calls, bufs = [], []
        for sel, packed, W64, n, mm in _iter_buckets(prep):
            calls.append([sel, None, W64, n, mm])
            bufs.append(packed)
        prep["stored_words"] = (prep["stored_fn"]()
                                if prep["stored_fn"] is not None else None)
    if calls:
        with metrics.span("decode.to_device"):
            shared = metrics.to_device(np.concatenate(bufs), dev)
        off = 0
        for c, buf in zip(calls, bufs):
            c[1] = (shared, off)
            off += buf.size
    return prep, [tuple(c) for c in calls]


def inflate_wave_device(stream: bytes, bit_offsets, out_sizes, hints=None,
                        device="cuda"):
    """Decode blocks on `device` (a torch device; the card by default,
    "cpu" for the plain kernel versions).  Returns (words np [B, 8192]
    int32 in block order, produced np [B], err np [B]).

    bit_offsets: absolute bit of each block's BFINAL bit (manifest);
    out_sizes: expected decoded size per block (manifest); hints:
    [B, >=W64] uint8 per-chunk entry phases, derived by a host walk when
    absent.  One host-to-device copy for all buckets, one device-to-host
    copy of all results."""
    prep, calls = prepare_bucketed(stream, bit_offsets, out_sizes, hints,
                                   device)
    B, md, err = prep["B"], prep["md"], prep["err"]
    words = np.zeros((B, WF.OW), np.int32)
    produced = np.zeros(B, np.int64)
    outs = [wave_decode_packed(buf, W64, n, off=off, maxl=ml, maxd=mdx)
            for _, (buf, off), W64, n, (ml, mdx) in calls]
    with metrics.span("decode.to_host"):
        if prep["stored_words"] is not None:
            words[prep["sidx"]] = prep["stored_words"]
            produced[prep["sidx"]] = md["stored_len"][prep["sidx"]]
        if outs:
            big = metrics.to_host(
                outs[0] if len(outs) == 1 else torch.cat(outs)).numpy()
            row = 0
            for sel, _, _, n, _ in calls:
                o = big[row:row + n]
                row += n
                words[sel] = o[:, :WF.OW]
                produced[sel] = o[:, WF.OW]
                err[sel] |= o[:, WF.OW + 1].astype(np.int64)
    return words, produced, err


def inflate_wave(stream: bytes, bit_offsets, out_sizes, hints=None,
                 device="cuda") -> tuple[bytes, np.ndarray]:
    """Host-assembled convenience wrapper; returns (bytes, err[B])."""
    words, produced, err = inflate_wave_device(
        stream, bit_offsets, out_sizes, hints, device)
    w = np.asarray(words).view(np.uint8).reshape(len(produced), -1)
    out = b"".join(w[b, :produced[b]].tobytes()
                   for b in range(len(produced)))
    return out, err


# ====================== skeleton-planned decode ============================
# The native skeleton walk (native/inflate.cpp dt_skeleton) cuts ANY
# conforming raw DEFLATE stream — including foreign zlib/gzip output whose
# blocks exceed 32 KiB or reference across block boundaries — into
# <= 32 KiB VIRTUAL BLOCKS with wavefront decode hints.  Stages A-F then
# run on all virtual blocks in parallel; only the walk and the ordered
# match fill (kernel K5, 32 KiB history carry) are sequential.

GROUP = 64                    # virtual blocks per wave_decode invocation


def skeleton_plan(stream: bytes):
    """Virtual-block plan for a bare raw DEFLATE stream, or None when the
    stream is malformed."""
    from deflate_tpu_torch import native as NAT

    try:
        return NAT.skeleton(bytes(stream))
    except ValueError:
        return None


def _wave_group(nw, hints, sizes, md, stop_bit, stored, W64: int):
    """One GROUP of planned virtual blocks through stages A-F, with
    stored blocks passed through (their window IS their output) and
    synthetic stops applied to cut blocks."""
    n = nw.shape[0]
    litw, r0, r1, nm, prod, e = W.wave_decode(
        nw, hints, sizes, md, W64, stop_bit=stop_bit)
    win = nw[:, :2 * W64 + 4]
    if 2 * W64 + 4 < WF.OW:
        win = torch.nn.functional.pad(win, (0, WF.OW - (2 * W64 + 4)))
    sw = stored[:, None]
    litw = torch.where(sw, win[:, :WF.OW], litw)
    recs = torch.stack([r0, r1], 2).reshape(n, 2 * W.NM)
    nm = torch.where(stored, 0, nm)
    prod = torch.where(stored, sizes, prod)
    e = torch.where(stored, 0, e)
    return litw, recs, nm, prod, e


def inflate_wave_planned(stream: bytes, plan, device="cuda"):
    """Decode a skeleton-planned stream on the wavefront path, on
    `device` (the card by default, "cpu" for the plain kernel versions).

    Returns (bytes, err np[n_vb]), or (None, all-ones err) when a
    virtual block's window exceeds the largest bucket.  Self-contained
    plans (every virtual block a whole parent block, no history) take
    the bucketed fast path (inflate_wave, K4); anything else takes the
    ordered path: grouped A-F in parallel, one history-carrying match
    fill (K5) over all virtual blocks in stream order, one pull to the
    host.
    """
    dev = torch_device(device)
    flags = np.asarray(plan["flags"], np.int64)
    n = len(flags)
    if n == 0:
        return b"", np.zeros(0, np.int64)
    whole = (flags & 2) > 0
    needs_hist = (flags & 4) > 0
    if whole.all() and not needs_hist.any():
        return inflate_wave(stream, plan["parent_bit"], plan["out_len"],
                            plan["hints"], device=dev)

    out_len = np.asarray(plan["out_len"], np.int64)
    span = np.asarray(plan["span_bits"], np.int64)
    stored = (flags & 1) > 0
    # window size: huffman vbs need the span (+1 bit for the synthetic
    # stop position); stored vbs need their payload bytes in-window
    need = np.where(stored, -(-out_len * 8 // 64), -(-(span + 1) // 64))
    W64 = next((b for b in BUCKETS if b >= int(need.max())), None)
    if W64 is None:
        return None, np.ones(n, np.int64)

    with metrics.span("decode.headers"):
        md = W.parse_headers_host(stream, plan["parent_bit"])
    npad = -(-n // GROUP) * GROUP

    def pad(a, fill=0):
        if len(a) == n and npad != n:
            return np.concatenate(
                [a, np.full((npad - n,) + a.shape[1:], fill, a.dtype)])
        return a

    with metrics.span("decode.windows"):
        nw = W.prepare_windows(stream, plan["start_bit"], W64)
        hints = np.full((n, W64), W.HINT_NONE, np.uint8)
        hav = min(W64, plan["hints"].shape[1])
        hints[:, :hav] = plan["hints"][:, :hav]
        stop = np.where(whole | stored, -1, span).astype(np.int32)
        stored_p = pad(stored)
        stored_p[n:] = True                 # padding rows pass through
        host = {"nw": pad(nw), "hints": pad(hints, W.HINT_NONE).astype(
                    np.int32),
                "sizes": pad(out_len.astype(np.int32)),
                "stop": pad(stop, -1), "stored": stored_p}
        host.update({k: pad(np.asarray(md[k]).astype(np.int32))
                     for k in MD_DEVICE_KEYS})

    # every group's operands in one copy each; the groups take row slices
    with metrics.span("decode.to_device"):
        d = {k: metrics.to_device(np.ascontiguousarray(v), dev)
             for k, v in host.items()}
    parts = []
    for g0 in range(0, npad, GROUP):
        g = {k: v[g0:g0 + GROUP] for k, v in d.items()}
        parts.append(_wave_group(
            g["nw"], g["hints"], g["sizes"],
            {k: g[k] for k in MD_DEVICE_KEYS}, g["stop"], g["stored"],
            W64))
    lit, recs, nm, prod, err = (torch.cat(x) for x in zip(*parts))
    with metrics.span("decode.fill"):
        filled = WF.fill_matches_hist(lit, recs, nm, d["sizes"])

    with metrics.span("decode.to_host"):
        w = metrics.to_host(filled[:n]).numpy().view(np.uint8).reshape(
            n, -1)
        produced = metrics.to_host(prod[:n]).numpy()
        err = metrics.to_host(err[:n]).numpy().astype(np.int64)
        err |= (produced != out_len).astype(np.int64)
        out = b"".join(w[b, :out_len[b]].tobytes() for b in range(n))
    return out, err
