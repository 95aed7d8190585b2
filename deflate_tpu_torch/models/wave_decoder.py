"""Wavefront device decoder — the batch front end of ops/wave.py.

Port of deflate_tpu/models/wave_decoder.py (self-contained streams with
hints).  Decodes B independent blocks on a torch device: header parse
and window extraction on the host, span bucketing (one bucket per window
size), stored blocks as a plain window copy, stages A-F
(ops/wave.wave_decode) and the match fill (kernel K4), then reassembly
in block order.

The reference packs each bucket's operands into one buffer because every
transfer cost a round trip on its TPU link; here each bucket's tensors
are handed to the device directly.
"""
from __future__ import annotations

import numpy as np
import torch

from deflate_tpu_torch.ops import wave as W
from deflate_tpu_torch.ops import wave_fill as WF

BUCKETS = (512, 1024, 1536, 2048, 2560, 3072, 3584, 4224)   # W64 sizes
MD_DEVICE_KEYS = W.MD_KEYS + ("l_litmask",)


def wave_decode_filled(nw, hints, sizes, md, W64: int, maxl: int = 15,
                       maxd: int = 15):
    """Stages A-F plus the match fill for one bucket.  Returns (filled
    words int32 [n, 8192], produced [n], err [n])."""
    litwords, rec0, rec1, nmatch, prod, err = W.wave_decode(
        nw, hints, sizes, md, W64, maxl=maxl, maxd=maxd)
    recs = WF.pack_fill_recs(rec0, rec1)
    return WF.fill_matches(litwords, recs, nmatch), prod, err


def _common_prep(stream: bytes, bit_offsets, out_sizes, hints):
    """Header parse + stored/Huffman classification."""
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
    if len(sidx):
        err[sidx] |= (md["stored_len"][sidx] != out_sizes[sidx])

    hidx_all = np.nonzero(~is_stored & ~md["hdr_err"])[0]
    overflow = span[hidx_all] > 64 * BUCKETS[-1]
    err[hidx_all[overflow]] = 1
    hidx_all = hidx_all[~overflow]
    return {"B": B, "md": md, "err": err, "sidx": sidx,
            "out_sizes": out_sizes, "hints": hints, "hidx_all": hidx_all,
            "need": -(-span[hidx_all] // 64), "stream": stream}


def _iter_buckets(prep):
    """Yield (sel, nw, hsel, sizes, W64, (maxl, maxd)) per non-empty span
    bucket; numpy operands."""
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
        yield sel, nw, hsel, prep["out_sizes"][sel], W64, (maxl, maxd)


def bucket_tensors(prep, sel, nw, hsel, sizes, device):
    """One bucket's operands as int32 tensors on `device`."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    md = {k: t(prep["md"][k][sel]) for k in MD_DEVICE_KEYS}
    return t(nw), t(hsel), t(sizes), md


def inflate_wave_device(stream: bytes, bit_offsets, out_sizes, hints=None,
                        device=None):
    """Decode blocks on `device` (torch.device; default CPU).  Returns
    (words np [B, 8192] int32 in block order, produced np [B], err np
    [B]).

    bit_offsets: absolute bit of each block's BFINAL bit (manifest);
    out_sizes: expected decoded size per block (manifest); hints:
    [B, >=W64] uint8 per-chunk entry phases, derived by a host walk when
    absent."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    prep = _common_prep(stream, bit_offsets, out_sizes, hints)
    B, md, err = prep["B"], prep["md"], prep["err"]
    words = np.zeros((B, WF.OW), np.int32)
    produced = np.zeros(B, np.int64)
    outs = []
    for sel, nw, hsel, sizes, W64, (ml, mdx) in _iter_buckets(prep):
        nwt, ht, st, mdt = bucket_tensors(prep, sel, nw, hsel, sizes, dev)
        outs.append((sel, wave_decode_filled(nwt, ht, st, mdt, W64,
                                             maxl=ml, maxd=mdx)))
    sidx = prep["sidx"]
    if len(sidx):
        words[sidx] = W.prepare_windows(stream, md["data_start"][sidx],
                                        4096)[:, :WF.OW]
        produced[sidx] = md["stored_len"][sidx]
    for sel, (filled, prod, e) in outs:
        words[sel] = filled.cpu().numpy()
        produced[sel] = prod.cpu().numpy()
        err[sel] |= e.cpu().numpy().astype(np.int64)
    return words, produced, err


def inflate_wave(stream: bytes, bit_offsets, out_sizes, hints=None,
                 device=None) -> tuple[bytes, np.ndarray]:
    """Host-assembled convenience wrapper; returns (bytes, err[B])."""
    words, produced, err = inflate_wave_device(
        stream, bit_offsets, out_sizes, hints, device)
    w = np.asarray(words).view(np.uint8).reshape(len(produced), -1)
    out = b"".join(w[b, :produced[b]].tobytes()
                   for b in range(len(produced)))
    return out, err
