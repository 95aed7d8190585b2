"""Port vs reference, the kernel and scatter emission backends: the packet
fusion (_emit_fields), the packet stage (_packet_pre, _route_packets,
_packet_post, build_packets), the scatter placement (emit_block), kernel
K7's plain version (pack_blocks) and the torch form of its design
(pack_blocks_tiles) against the Pallas kernel in interpret mode, and
ops/bitpack.py — all with zero tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deflate_tpu.models import encoder as JE
from deflate_tpu.ops import bitpack as JBP
from deflate_tpu.ops import pallas_pack as JPK
from deflate_tpu_torch.models import encoder as E
from deflate_tpu_torch.ops import bitpack as BP
from deflate_tpu_torch.ops import pack as PK
from torch_helpers import (BLOCK, PACK_CASES, assert_same, corpus, np_i32,
                           pack_case, pack_spill)

LEVEL = 2


def _short_blocks():
    """Four short blocks (64-500 bytes): text, a repeat, words, random —
    dynamic, fixed and stored encodings, short packet lists."""
    rng = np.random.default_rng(23)
    datas = [corpus(1, seed=2)[:500], b"abcabcabd" * 20,
             corpus(1, seed=4)[2 * 8192:2 * 8192 + 300],
             rng.integers(0, 256, 64, dtype=np.uint8).tobytes()]
    blocks = np.zeros((len(datas), BLOCK), np.uint8)
    blens = np.zeros(len(datas), np.int32)
    for i, d in enumerate(datas):
        blocks[i, :len(d)] = np.frombuffer(d, np.uint8)
        blens[i] = len(d)
    return blocks, blens


@pytest.fixture(scope="module")
def planned():
    """Both packages' stage A and B on the short blocks, plus the JAX
    stage-C functions under jax.vmap (one jit)."""
    blocks, blens = _short_blocks()
    B = len(blens)
    jb, jn = jnp.asarray(blocks), jnp.asarray(blens)
    live = np.ones(B, bool)

    @jax.jit
    def ref(jb, jn):
        plans = JE.batch_plan(jb, jn, LEVEL)
        choice, pad, _, _ = JE.choose_blocks(
            plans["fixed_bits"], plans["dyn_bits"], jn, jnp.asarray(live),
            LEVEL, jnp.int32(0))
        bfinal = jnp.arange(B) == B - 1

        def vm(fn):
            return jax.vmap(lambda bl, ln, i, ch, pd, bf: fn(
                bl, ln, jax.tree.map(lambda x: x[i], plans), ch, pd, bf))(
                    jb, jn, jnp.arange(B), choice, pad, bfinal)

        pre = vm(JE._packet_pre)
        return {"fields": vm(JE._emit_fields), "pre": pre,
                "emit": vm(JE.emit_block), "build": vm(JE.build_packets)}

    want = ref(jb, jn)
    want["post"] = jax.vmap(JE._packet_post)(
        want["pre"], *JE._route_packets(want["pre"], interpret=True))

    tb, tn = torch.from_numpy(blocks), torch.from_numpy(blens)
    plans = E.batch_plan(tb, tn, LEVEL)
    choice, pad, _, _ = E.choose_blocks(
        plans["fixed_bits"], plans["dyn_bits"], tn, torch.from_numpy(live),
        LEVEL, 0)
    bfinal = torch.arange(B) == B - 1
    return want, (tb, tn, plans, choice, pad, bfinal)


def test_emit_fields_match_reference(planned):
    want, args = planned
    got = E._emit_fields(*args)
    for k in ("lo", "hi", "sh", "sh_sym", "live_tok", "is_match", "len",
              "n_live", "stored", "hdr3", "hdr3_l", "hv", "hl", "eob_v",
              "eob_len"):
        assert_same(got[k], want["fields"][k], k)
    # the fusion merged packets: fewer live lanes than token starts
    assert (got["n_live"] < got["sh_sym"].gt(0).sum(1)).any()


def test_packet_pre_matches_reference(planned):
    want, args = planned
    got = E._packet_pre(*args)
    for k in ("lo_t", "hi_t", "sh_t", "delta", "hdr_lo", "hdr_lens",
              "n_live", "stored"):
        assert_same(got[k], want["pre"][k], k)


@pytest.mark.parametrize("stage", ["post", "build"])
def test_packet_lists_match_reference(planned, stage):
    """_route_packets + _packet_post (against the reference's routing
    kernel in interpret mode) and build_packets (against its XLA
    routing): offsets, payloads, counts, bits, stored flags."""
    want, args = planned
    if stage == "post":
        pre = E._packet_pre(*args)
        got = E._packet_post(pre, *E._route_packets(pre))
    else:
        got = E.build_packets(*args)
    for g, w, name in zip(got, want[stage],
                          ("off", "lo", "hi", "count", "nbits", "stored")):
        assert_same(g, w, f"{stage} {name}")


def test_emit_block_matches_reference(planned):
    want, args = planned
    assert_same(E.emit_block(*args), want["emit"], "scatter words")


def test_pack_blocks_plain_matches_interpret(planned):
    want, args = planned
    off, lo, hi, counts, nbits, stored = E.build_packets(*args)
    assert 600 < int(counts.min()) and int(counts.max()) < 800
    jw = JPK.pack_blocks(*(jnp.asarray(x.numpy())
                           for x in (counts, off, lo, hi)), interpret=True)
    got = PK.pack_blocks(counts, off, lo, hi)
    assert got.shape == (4, PK.OUTW)
    assert_same(got, jw, "packed words")
    assert_same(PK.pack_blocks_tiles(counts, off, lo, hi), jw, "tiles")
    # and through _finish_block these are the scatter backend's words
    tb, tn, _, _, pad, _ = args
    assert_same(E._finish_block(got[:, :E.WB], tb, tn, stored, pad, nbits),
                want["emit"], "finished words")


def test_pack_blocks_plain_random_packets():
    """Dense random packets of 0-48 bits at every bit phase, counts short
    of NPK: the plain version against the Pallas kernel (interpret)."""
    rng = np.random.default_rng(3)
    B, n = 4, 600
    counts = np.array([n, 17, 0, n - 5], np.int32)
    width = rng.integers(0, 49, (B, PK.NPK))
    width[:, n:] = 0
    off = (np.cumsum(width, 1) - width).astype(np.int32)
    val = rng.integers(0, 1 << 62, (B, PK.NPK), dtype=np.int64)
    val &= (np.int64(1) << width.astype(np.int64)) - 1
    val[np.arange(PK.NPK)[None, :] >= counts[:, None]] = 0
    lo = (val & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    hi = (val >> 32).astype(np.int32)
    jw = JPK.pack_blocks(*(jnp.asarray(x) for x in (counts, off, lo, hi)),
                         interpret=True)
    got = PK.pack_blocks(*(torch.from_numpy(x)
                           for x in (counts, off, lo, hi)))
    assert_same(got, jw, "packed words")


@pytest.mark.parametrize("case", PACK_CASES)
def test_pack_blocks_tiles_matches_plain_and_interpret(case):
    """The torch form of K7's design (tiles, searchsorted ranges from
    W0 - 2, dead tiles, zero payloads skipped) against the plain version
    and the Pallas kernel (interpret) on every edge case of pack_case.

    Words at or past OUTW are dropped by the contract; in interpret mode
    the Pallas kernel's out-of-range SMEM stores clamp onto word OUTW - 1
    instead, so there the reference's last word is ours ORed with the
    row's dropped words (pack_spill, zero in every other case)."""
    counts, off, lo, hi = pack_case(case)
    args = [torch.from_numpy(x) for x in (counts, off, lo, hi)]
    got = PK.pack_blocks_tiles(*args)
    assert got.shape == (len(counts), PK.OUTW)
    assert_same(got, PK.pack_blocks_plain(*args), f"{case}: tiles vs plain")
    jw = np_i32(JPK.pack_blocks(*(jnp.asarray(x)
                                  for x in (counts, off, lo, hi)),
                                interpret=True))
    spill = pack_spill(counts, off, lo, hi)
    assert (spill != 0).any() == (case == "past_outw")
    want = np_i32(got)
    want[:, -1] |= spill
    assert_same(want, jw, f"{case}: tiles vs interpret")


@pytest.mark.parametrize("batched", [False, True])
def test_pack_bits_matches_reference(batched):
    rng = np.random.default_rng(int(batched))
    shape = (3, 700) if batched else (700,)
    vals = rng.integers(-2**31, 2**31, shape).astype(np.int32)
    lens = rng.integers(0, 17, shape).astype(np.int32)
    fn = jax.vmap(JBP.pack_bits, (0, 0, None)) if batched else JBP.pack_bits
    jw, jt = fn(jnp.asarray(vals), jnp.asarray(lens), 200)
    tw, tt = BP.pack_bits(torch.from_numpy(vals), torch.from_numpy(lens),
                          200)
    assert_same(tw, jw, "words")
    assert_same(tt, jt, "total bits")


def test_concat_and_peek_bits_match_reference():
    rng = np.random.default_rng(9)
    B, W = 5, 40
    bits = rng.integers(0, 32 * W, B).astype(np.int32)
    words = rng.integers(0, 2**32, (B, W), dtype=np.uint64)
    for b in range(B):                   # zero the bits past bits[b]
        full, rem = divmod(int(bits[b]), 32)
        words[b, full] &= (1 << rem) - 1
        words[b, full + 1:] = 0
    words = words.astype(np.uint32)
    for cap in (B * W, int(bits.sum()) // 32 - 3):
        jw, jt = JBP.concat_bitstreams(jnp.asarray(words), jnp.asarray(bits),
                                       cap)
        tw, tt = BP.concat_bitstreams(
            torch.from_numpy(words.view(np.int32)), torch.from_numpy(bits),
            cap)
        assert_same(tw, jw, f"concatenated words, cap {cap}")
        assert int(tt) == int(jt)
    pos = rng.integers(0, 32 * B * W + 70, (7, 9)).astype(np.int32)
    for n in (1, 13, 32):
        assert_same(BP.peek_bits(tw, torch.from_numpy(pos), n),
                    JBP.peek_bits(jw, jnp.asarray(pos), n), f"peek {n}")
    data = rng.integers(0, 256, 45, dtype=np.uint8).tobytes()
    jwb, jn = JBP.bytes_to_words(data)
    twb, tn = BP.bytes_to_words(data)
    assert (twb == jwb).all() and tn == jn
    assert BP.words_to_bytes(torch.from_numpy(twb.view(np.int32)), 333) == \
        JBP.words_to_bytes(jwb, 333) == data[:42]

