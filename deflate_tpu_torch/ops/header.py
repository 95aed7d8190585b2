"""Dynamic-Huffman block header writer (RFC 1951 §3.2.7), batched.

Port of deflate_tpu/ops/header.py: each combined code-length position
maps to at most one RLE op decided from (run value, run length,
position-within-run); the CL tree is built from the actual op histogram.
All functions take a leading batch dimension B.
"""
from __future__ import annotations

import torch

from deflate_tpu_torch.ops import huffman as H
from deflate_tpu_torch.utils import metrics
from deflate_tpu_torch.utils.bits import I32, I64
from deflate_tpu_torch.utils.tables import (CL_ORDER, MAX_CL_CODE_LEN,
                                            NUM_CL, NUM_LITLEN)

ND = 30                             # transmitted dist lengths
NL = NUM_LITLEN + ND                # combined slots (318)
HEADER_ENTRIES = 3 + NUM_CL + 2 * NL


def rle_ops(litlen_lens: torch.Tensor, dist_lens: torch.Tensor):
    """litlen_lens [B, 288], dist_lens [B, 30] -> (sym [B, NL] CL symbol
    or -1, extra_val, extra_bits, hlit [B], hdist [B])."""
    dev = litlen_lens.device
    B = litlen_lens.shape[0]
    i = torch.arange(NL, dtype=I32, device=dev)[None, :]
    lit_i = torch.arange(NUM_LITLEN, dtype=I32, device=dev)
    dist_i = torch.arange(ND, dtype=I32, device=dev)
    max_lit = torch.where(litlen_lens > 0, lit_i, 0).max(1).values
    hlit = torch.clamp(max_lit + 1, min=257)[:, None]
    max_dist = torch.where(dist_lens > 0, dist_i, -1).max(1).values
    hdist = torch.clamp(max_dist + 1, min=1)[:, None]

    dist_idx = torch.clamp(i - hlit, 0, ND - 1).to(I64)
    lit_v = torch.gather(litlen_lens, 1,
                         torch.clamp(i, 0, NUM_LITLEN - 1).to(I64)
                         .expand(B, NL))
    val = torch.where(i < hlit, lit_v,
                      torch.where(i < hlit + hdist,
                                  torch.gather(dist_lens, 1, dist_idx),
                                  -(i + 10)))
    active = i < hlit + hdist

    prev = torch.cat([torch.full((B, 1), -99, dtype=I32, device=dev),
                      val[:, :-1]], 1)
    new_run = val != prev
    run_id = (torch.cumsum(new_run.to(I32), 1) - 1).to(I64)
    # runs are contiguous: a run's start is the last run head at or
    # before i
    run_start = torch.cummax(torch.where(new_run, i, 0), 1).values
    run_len = torch.zeros((B, NL), dtype=I32, device=dev).scatter_add(
        1, run_id, active.to(I32)).gather(1, run_id)
    pos = i - run_start

    # ---- zero runs: op18 (11-138 zeros) / op17 (3-10) / literal zeros
    chunk = pos // 138
    zc_size = torch.clamp(run_len - chunk * 138, max=138)
    z_is_start = pos % 138 == 0
    z_op18 = z_is_start & (zc_size >= 11)
    z_op17 = z_is_start & (zc_size >= 3) & (zc_size < 11)
    z_lit = zc_size < 3

    # ---- nonzero runs: first literal, then op16 chunks of 3-6 repeats
    q = pos - 1
    nchunk = q // 6
    nc_size = torch.clamp((run_len - 1) - nchunk * 6, max=6)
    n_first = pos == 0
    n_op16 = (pos > 0) & (q % 6 == 0) & (nc_size >= 3)
    n_lit = (pos > 0) & (nc_size < 3)

    zero = val == 0
    sym = torch.where(zero & z_op18, 18,
          torch.where(zero & z_op17, 17,
          torch.where(zero & z_lit, 0,
          torch.where(~zero & (n_first | n_lit), val,
          torch.where(~zero & n_op16, 16, -1))))).to(I32)
    emits = active & torch.where(zero, z_op18 | z_op17 | z_lit,
                                 n_first | n_op16 | n_lit)
    sym = torch.where(emits, sym, -1)

    extra_bits = torch.where(sym == 16, 2,
                 torch.where(sym == 17, 3,
                 torch.where(sym == 18, 7, 0))).to(I32)
    extra_val = torch.where(sym == 16, nc_size - 3,
                torch.where(sym == 17, zc_size - 3,
                torch.where(sym == 18, zc_size - 11, 0))).to(I32)
    return sym, extra_val, extra_bits, hlit[:, 0], hdist[:, 0]


def header_pre(litlen_lens: torch.Tensor, dist_lens: torch.Tensor):
    """Header stage 1: RLE ops + CL-alphabet histogram [B, 19]."""
    sym, extra_val, extra_bits, hlit, hdist = rle_ops(litlen_lens, dist_lens)
    cl_hist = torch.zeros((sym.shape[0], NUM_CL), dtype=I32,
                          device=sym.device).scatter_add(
        1, torch.clamp(sym, 0, NUM_CL - 1).to(I64), (sym >= 0).to(I32))
    return {"sym": sym, "extra_val": extra_val, "extra_bits": extra_bits,
            "hlit": hlit, "hdist": hdist, "cl_hist": cl_hist}


def header_post(pre, cl_lens: torch.Tensor):
    """Header stage 2: transmit-order fields from the built CL tree.
    Returns (vals [B, HEADER_ENTRIES], lens [B, HEADER_ENTRIES],
    total_bits [B])."""
    sym, extra_val, extra_bits = pre["sym"], pre["extra_val"], \
        pre["extra_bits"]
    B = sym.shape[0]
    dev = sym.device
    cl_codes, _ = H.canonical_codes(cl_lens)
    order = metrics.to_device(torch.as_tensor(CL_ORDER, dtype=I64), dev)
    perm_lens = cl_lens[:, order]
    ar = torch.arange(NUM_CL, dtype=I32, device=dev)
    last = torch.where(perm_lens > 0, ar, 0).max(1).values
    hclen = torch.clamp(last + 1, min=4)

    pre_vals = torch.stack([pre["hlit"] - 257, pre["hdist"] - 1,
                            hclen - 4], 1).to(I32)
    pre_lens = metrics.to_device(torch.tensor([5, 5, 4], dtype=I32),
                                 dev).expand(B, 3)
    cll = torch.where(ar[None, :] < hclen[:, None], 3, 0).to(I32)

    s = torch.clamp(sym, 0, NUM_CL - 1).to(I64)
    code_vals = torch.where(sym >= 0, torch.gather(cl_codes, 1, s), 0)
    code_lens = torch.where(sym >= 0, torch.gather(cl_lens, 1, s), 0)
    op_vals = torch.stack([code_vals, extra_val], 2).reshape(B, -1)
    op_lens = torch.stack([code_lens, extra_bits], 2).reshape(B, -1)

    vals = torch.cat([pre_vals, perm_lens.to(I32), op_vals.to(I32)], 1)
    lens = torch.cat([pre_lens, cll, op_lens.to(I32)], 1)
    return vals, lens, lens.sum(1).to(I32)


def emit_dynamic_header(litlen_lens: torch.Tensor, dist_lens: torch.Tensor):
    """Single-block form: (vals [HEADER_ENTRIES], lens, total_bits)."""
    pre = header_pre(litlen_lens[None], dist_lens[None])
    cl_lens = H.huffman_code_lengths(pre["cl_hist"][0], MAX_CL_CODE_LEN)
    vals, lens, total = header_post(pre, cl_lens[None])
    return vals[0], lens[0], total[0]
