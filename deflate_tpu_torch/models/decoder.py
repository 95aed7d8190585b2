"""Speculative device INFLATE: a whole raw DEFLATE stream decoded by
array code.

Port of deflate_tpu/models/decoder.py (plain XLA there, no Pallas
kernel; eager torch here, no new CUDA kernel).  Each block decodes in
three data-parallel phases: a speculative token at every bit offset, the
true chain by pointer doubling, and the output by a prefix sum
(ops/inflate_scan.py; dynamic headers by ops/header_decode.py).  A loop
over blocks carries only the two true serial dependencies of the
format: the bit position and the output position.  Back-references
that cross blocks (RFC-legal) are resolved in global output coordinates
after the loop, by pointer doubling.

Capacities are fixed per call: `span` bits of compressed body and
`out_cap` output bytes per block, `max_blocks` blocks.  A stream that
overflows them sets the error flag; ``inflate_device`` then retries with
larger capacities and at last takes the host decoder.  Every function
runs on the device of its words; only the error flag and the final
bytes come back to the host (and ``decode_stream``'s done flag, now and
then).
"""
from __future__ import annotations

import numpy as np
import torch

from deflate_tpu_torch.models import host_inflate as HI
from deflate_tpu_torch.ops import bitpack as BP
from deflate_tpu_torch.ops import header_decode as HD
from deflate_tpu_torch.ops import inflate_scan as IS
from deflate_tpu_torch.utils import metrics
from deflate_tpu_torch.utils import tables as T
from deflate_tpu_torch.utils.bits import I32, I64

CHECK_EVERY = 8      # decode_stream reads its done flag after blocks 1, 2
                     # and 4, then every this many blocks


def _byte_at(words: torch.Tensor, bytepos: torch.Tensor) -> torch.Tensor:
    """Bytes at byte offsets `bytepos` of the int32 word array (offsets
    past the end read the last word, as the reference's clip does)."""
    w = words[torch.clamp(bytepos >> 2, 0, words.shape[0] - 1).to(I64)]
    return (w >> (8 * (bytepos & 3))) & 0xFF


def _kraft_bad(lens: torch.Tensor) -> torch.Tensor:
    """True for an oversubscribed code (a bad tree would mis-decode
    silently through the LUT)."""
    L = torch.arange(1, T.MAX_CODE_LEN + 1, dtype=I32, device=lens.device)
    cnt = (lens[:, None] == L).sum(0)
    return (cnt * (1 << (T.MAX_CODE_LEN - L))).sum() > (1 << T.MAX_CODE_LEN)


def decode_block(words: torch.Tensor, start, span: int, out_cap: int,
                 nbits=None):
    """Decode one block from bit offset `start` (its BFINAL bit).

    Returns a dict of tensors on the words' device:
      bfinal (int32); error (bool: a btype-3 block, a bad stored block
      or a bad Huffman block); next_start (int32 bit offset after the
      block); produced (int32 output bytes);
      lit_flag uint8 [out_cap] — 1 where the byte is a literal;
      lit_val int32 [out_cap] — the literal byte;
      rel_src int32 [out_cap] — for copied bytes, the distance back.
    nbits, when given, is the stream's length in bits: a stored block
    that runs past it is an error."""
    dev = words.device
    start = torch.as_tensor(start, device=dev).to(I32)
    bfinal = BP.peek_bits(words, start, 1)
    btype = BP.peek_bits(words, start + 1, 2)

    # ---- stored block ----------------------------------------------------
    data_pos = (start + 3 + 7) & ~7                 # byte aligned
    s_len = BP.peek_bits(words, data_pos, 16)
    s_nlen = BP.peek_bits(words, data_pos + 16, 16)
    stored_err = (s_len ^ s_nlen) != 0xFFFF
    if nbits is not None:
        stored_err = stored_err | (data_pos + 32 + 8 * s_len > nbits)
    o = torch.arange(out_cap, dtype=I32, device=dev)
    stored_bytes = _byte_at(words, ((data_pos + 32) >> 3) + o)
    stored_next = data_pos + 32 + 8 * s_len

    # ---- Huffman blocks --------------------------------------------------
    hdr = HD.parse_dynamic_header(words, start + 3)
    is_dyn = btype == 2
    lit_lens = torch.where(is_dyn, hdr["litlen_lens"], torch.as_tensor(
        T.FIXED_LITLEN_LENGTHS, dtype=I32, device=dev))
    dist_lens = torch.where(is_dyn, hdr["dist_lens"], torch.as_tensor(
        T.FIXED_DIST_LENGTHS[:30], dtype=I32, device=dev))
    body_start = torch.where(is_dyn, hdr["body_start"], start + 3)
    tree_err = _kraft_bad(lit_lens) | _kraft_bad(dist_lens)

    tok = IS.token_scan(words, IS.build_lut(lit_lens),
                        IS.build_lut(dist_lens), body_start, span=span)
    reached, eob_local, chain_err = IS.find_chain(tok, span=span)

    adv = torch.where(reached, tok["out_adv"], 0)
    opos = (torch.cumsum(adv, 0) - adv).to(I32)
    produced_h = adv.sum().to(I32)
    overflow = (produced_h > out_cap) | (eob_local >= span)

    # per-output-byte info: the owning token's start (filled forward),
    # literal or copy; indices are clipped, so tokens past the end all
    # land on the last slot and the max decides
    idx = torch.clamp(opos, 0, out_cap - 1)
    is_lit = reached & tok["is_lit"]
    is_m = reached & tok["is_match"]
    tstart = IS.scatter_max(
        torch.full((out_cap,), -1, dtype=I32, device=dev), idx,
        torch.where(reached & (tok["out_adv"] > 0), opos, -1))
    tstart = torch.cummax(tstart, 0).values
    zero = torch.zeros(out_cap, dtype=I32, device=dev)
    litv = IS.scatter_max(zero, idx, torch.where(is_lit, tok["lit"], 0))
    dstv = IS.scatter_max(zero, idx, torch.where(is_m, tok["dist"], 0))
    litf = IS.scatter_max(zero, idx, is_lit.to(I32))

    ts = torch.clamp(tstart, 0, out_cap - 1).to(I64)
    h_lit_flag = (litf[ts] > 0) & (tstart >= 0)
    huff_next = body_start + eob_local + tok["nbits"][
        torch.clamp(eob_local, 0, span - 1).to(I64)]
    huff_err = chain_err | overflow | tree_err | (is_dyn & hdr["error"])

    # ---- select by block type -------------------------------------------
    is_stored = btype == 0
    produced = torch.where(is_stored, s_len, produced_h)
    error = torch.where(is_stored, stored_err, (btype == 3) | huff_err)
    live = o < produced
    lit_flag = torch.where(is_stored, 1, h_lit_flag.to(I32))
    return {"bfinal": bfinal, "error": error,
            "next_start": torch.where(is_stored, stored_next,
                                      huff_next).to(I32),
            "produced": produced.to(I32),
            "lit_flag": torch.where(live, lit_flag, 0).to(torch.uint8),
            "lit_val": torch.where(is_stored, stored_bytes,
                                   litv[ts]).to(I32),
            "rel_src": torch.where(live & ~is_stored, dstv[ts], 0).to(I32)}


def _resolve(known: torch.Tensor, val: torch.Tensor, src: torch.Tensor,
             rounds: int) -> torch.Tensor:
    """Copy chains by pointer doubling: each unknown byte takes the value
    of the byte its source chain ends in.  Returns the values."""
    src = src.to(I64)
    for _ in range(rounds):
        ks = known[src]
        val = torch.where((known == 0) & (ks > 0), val[src], val)
        known = torch.maximum(known, ks)
        src = torch.where(known > 0, src, src[src])
    return val


def decode_stream(words: torch.Tensor, nbits: int, span: int, out_cap: int,
                  max_blocks: int):
    """Decode a whole raw DEFLATE stream on the words' device.

    Returns (out uint8 [max_blocks * out_cap], total int32, nblocks
    int32, error bool), tensors on that device; out[:total] is the
    payload.  The block loop stops early once the stream is done or
    has failed (the flag is read after blocks 1, 2 and 4, then every
    CHECK_EVERY blocks): every later step of the reference's max_blocks
    produces nothing, so the results are the same."""
    dev = words.device
    total_cap = max_blocks * out_cap
    pos = torch.zeros((), dtype=I32, device=dev)
    base = torch.zeros((), dtype=I32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    err = torch.zeros((), dtype=torch.bool, device=dev)
    ys = []
    for b in range(max_blocks):
        blk = decode_block(words, pos, span, out_cap, nbits)
        # next_start > nbits: the body ran past the end of the input,
        # where peek_bits reads zeros (the all-zero fixed code is EOB)
        this_err = ~done & (blk["error"] | (pos >= nbits)
                            | (blk["next_start"] > nbits))
        stop = done | this_err
        produced = torch.where(stop, 0, blk["produced"])
        ys.append((blk["lit_flag"], blk["lit_val"], blk["rel_src"], base,
                   produced))
        done = stop | (blk["bfinal"] > 0)
        pos = torch.where(stop, pos, blk["next_start"])
        base = base + produced
        err = err | this_err
        if (b + 1 in (1, 2, 4) or (b + 1) % CHECK_EVERY == 0) and bool(done):
            break
    total = base
    error = err | ~done                              # ran out of block slots

    # ---- assemble global arrays -----------------------------------------
    lit_flag, lit_val, rel_src, bases, produced = (torch.stack(y)
                                                   for y in zip(*ys))
    o = torch.arange(out_cap, dtype=I32, device=dev)[None, :]
    live = o < produced[:, None]
    tgt = torch.where(live, bases[:, None] + o, total_cap).reshape(-1)
    zero = torch.zeros(total_cap, dtype=I32, device=dev)
    known = IS.scatter_max(zero, tgt, lit_flag.to(I32).reshape(-1))
    val = IS.scatter_max(zero, tgt, torch.where(live, lit_val, 0).reshape(-1))
    rel = IS.scatter_max(zero, tgt, torch.where(live, rel_src, 0).reshape(-1))

    g = torch.arange(total_cap, dtype=I32, device=dev)
    src = torch.where(known > 0, g, g - rel)
    unknown = (known == 0) & (g < total)
    error = error | (unknown & (src < 0)).any() | (unknown & (src >= g)).any()
    val = _resolve(known, val, torch.clamp(src, 0, total_cap - 1),
                   max(1, (total_cap - 1).bit_length()))
    return (val.to(torch.uint8), total, (produced > 0).sum().to(I32),
            error)


def decode_block_standalone(words: torch.Tensor, start, span: int,
                            out_cap: int):
    """Decode ONE block whose back-references stay inside it (this
    package's encoder's Q5 invariant: every block it emits is
    self-contained), for the data-parallel manifest decode.  Returns
    (out uint8 [out_cap], produced int32, error bool)."""
    blk = decode_block(words, start, span, out_cap)
    o = torch.arange(out_cap, dtype=I32, device=words.device)
    known = blk["lit_flag"].to(I32)
    src = torch.where(known > 0, o, o - blk["rel_src"])
    live = o < blk["produced"]
    error = blk["error"] | (live & (known == 0) & (src < 0)).any()
    val = _resolve(known, blk["lit_val"], torch.clamp(src, 0, out_cap - 1),
                   max(1, (out_cap - 1).bit_length()))
    return val.to(torch.uint8), blk["produced"], error


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def inflate_device(data: bytes, out_size_hint: int | None = None,
                   device="cuda") -> bytes:
    """Decode a raw DEFLATE stream on `device` (the card by default; it
    must exist), trying two capacity configurations in turn and taking
    the host decoder only after both flag an error.  out_size_hint only
    sizes the capacities."""
    from deflate_tpu_torch._build import torch_device

    dev = torch_device(device)
    words_np, nbits = BP.bytes_to_words(data)
    words = torch.from_numpy(words_np.view(np.int32)).to(dev)
    hint = out_size_hint if out_size_hint else max(4 * len(data), 1 << 16)
    # max_blocks in powers of two, as the reference buckets its compiles
    configs = [
        (IS.SPAN, T.BLOCK_SIZE, _pow2(max(8, -(-hint // T.BLOCK_SIZE) + 2))),
        ((1 << 20) + 64, 1 << 20, _pow2(max(4, -(-hint // (1 << 20)) + 2))),
    ]
    for span, out_cap, max_blocks in configs:
        out, total, _, error = decode_stream(words, nbits, span, out_cap,
                                             max_blocks)
        if not bool(error):
            metrics.count("decode.path.speculative")
            return out[:int(total)].cpu().numpy().tobytes()
    metrics.count("decode.path.speculative_host")
    return HI.inflate_raw(data, out_size_hint)
