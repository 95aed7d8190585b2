"""Port vs reference, kernel K6 (full block inflate): the host tables
equal deflate_tpu's, and inflate_blocks' plain version returns the same
err flags as the reference kernel (Pallas interpret mode) on every
block, and the same produced count, end bit and bytes wherever err is 0
— fixed, dynamic, stored, long-code, far-match and near-distance blocks,
a multi-block stream of this package's encoder, and corrupt blocks."""
import zlib

import numpy as np
import pytest

from deflate_tpu.ops import pallas_inflate as PI
from deflate_tpu.utils import tables as JT
from deflate_tpu_torch.ops import block_inflate as BI
from deflate_tpu_torch.runtime import manifest as M
from torch_helpers import corpus


def deflate_raw(data, level=6, strategy=0):
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    return c.compress(data) + c.flush()


def compare(stream: bytes, offs):
    """Both decoders on the same blocks; returns the port's outputs."""
    jo, jp, je, jb = PI.inflate_blocks(stream, offs, interpret=True)
    to, tp, te, tb = BI.inflate_blocks(stream, offs, device="cpu")
    assert (te != 0).tolist() == (np.asarray(je) != 0).tolist()
    for b in range(len(offs)):
        if je[b] == 0:
            assert int(tp[b]) == int(jp[b]) and int(tb[b]) == int(jb[b]), b
            assert (to[b, :tp[b]] == jo[b, :jp[b]]).all(), b
    return to, tp, te, tb


def test_statics_equal_reference():
    assert (BI.make_statics() == PI.make_statics()).all()


@pytest.mark.parametrize("lens, root, cap, kind", [
    (JT.FIXED_LITLEN_LENGTHS, 9, 896, "lit"),
    (JT.FIXED_DIST_LENGTHS[:30], 6, 704, "dist"),
    ([12, 0, 11, 0, 12, 11, 11, 11, 10, 11, 9, 9, 7, 7, 6, 6, 5, 5, 4, 4,
      3, 3, 2, 3, 6, 6, 5, 5, 5, 7], 6, 704, "dist"),
    ([1] + [0] * 29, 6, 704, "dist"),
    ([1, 1, 1] + [0] * 285, 9, 896, "lit"),
    ([2, 3, 3, 1, 0, 0, 4, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 5], 7, 128,
     "cl"),
], ids=["fixed_lit", "fixed_dist", "long_dist", "single_code",
        "oversubscribed", "cl"])
def test_build_table_host_equals_reference(lens, root, cap, kind):
    lens = np.asarray(lens, np.int32)
    pay = {"lit": (BI._litlen_payload, PI._litlen_payload, PI.INVALID),
           "dist": (BI._dist_payload, PI._dist_payload, PI.D_INVALID),
           "cl": (BI._cl_payload, PI._cl_payload, PI.INVALID)}[kind]
    got, gerr = BI.build_table_host(lens, root, cap, pay[0], pay[2])
    want, werr = PI.build_table_host(lens, root, cap, pay[1], pay[2])
    assert gerr == werr
    assert (got == want).all()


def _cases():
    rng = np.random.default_rng(1)
    rnd = rng.integers(0, 256, 20000, dtype=np.uint8).tobytes()
    return {
        "fixed": deflate_raw(b"hello hello hello world" * 10, 6,
                             zlib.Z_FIXED),
        "dynamic": deflate_raw(bytes((rng.integers(0, 8, 4000) * 31
                                      % 256).astype(np.uint8)), 9),
        "stored": deflate_raw(rng.integers(0, 256, 5000,
                                           dtype=np.uint8).tobytes(), 6),
        "long_codes": deflate_raw(bytes(rng.integers(0, 250, 3000)
                                        .astype(np.uint8)), 9),
        "far_match": deflate_raw(rnd + rnd[:5000], 6),
        "near_dists": deflate_raw(b"a" * 300 + b"ab" * 150 + b"abc" * 100
                                  + bytes(range(7)) * 60, 9),
        "empty": deflate_raw(b""),
    }


@pytest.mark.parametrize("name", ["fixed", "dynamic", "stored", "long_codes",
                                  "far_match", "near_dists", "empty"])
def test_single_blocks_match_reference(name):
    st = _cases()[name]
    to, tp, te, _ = compare(st, [0])
    assert te[0] == 0
    assert to[0, :tp[0]].tobytes() == zlib.decompress(st, -15)[:tp[0]]


def test_own_multiblock_stream_matches_reference():
    data = corpus(3, seed=51)[:3 * 32768 - 999]
    stream, man = M.compress_with_manifest(data, level=2, hints=False,
                                           device="cpu")
    offs = [b[0] for b in man.blocks]
    to, tp, te, tb = compare(stream, offs)
    assert not te.any()
    assert list(tp) == [b[2] for b in man.blocks]
    assert list(tb) == [b[0] + b[1] for b in man.blocks]
    assert b"".join(to[i, :tp[i]].tobytes() for i in range(len(offs))) \
        == data


def _pack(fields) -> bytes:
    """(value, nbits) fields, LSB-first, as bytes."""
    acc = nb = 0
    for v, n in fields:
        acc |= v << nb
        nb += n
    return acc.to_bytes(-(-nb // 8) + 4, "little")


def _corrupt():
    rng = np.random.default_rng(4)
    bad_nlen = bytearray(deflate_raw(b"x" * 50, 0))
    bad_nlen[3] ^= 0xFF
    dyn = bytearray(deflate_raw(bytes((rng.integers(0, 8, 3000) * 31
                                       % 256).astype(np.uint8)), 9))
    dyn[4] ^= 0x55
    # two blocks; the second's matches reach into the first: decoded on
    # its own, its distances run past the block start
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    text = b"The quick brown fox jumps over the lazy dog. " * 40
    two = c.compress(text) + c.flush(zlib.Z_SYNC_FLUSH)
    first_bits = 8 * len(two)
    two += c.compress(text) + c.flush()
    # dynamic headers: 19 CL codes of length 1 (over-subscribed), and 19
    # of length 7 (incomplete)
    hdr = [(1, 1), (2, 2), (0, 5), (0, 5), (15, 4)]
    oversub = _pack(hdr + [(1, 3)] * 19)
    incomplete = _pack(hdr + [(7, 3)] * 19)
    return {"bad_nlen": (bytes(bad_nlen), 0),
            "reserved_btype": (bytes([0x07, 0x00]), 0),
            "header_bits_flipped": (bytes(dyn), 0),
            "oversubscribed_cl": (oversub, 0),
            "incomplete_cl": (incomplete, 0),
            "distance_too_far": (two, first_bits),
            "truncated": (bytes(dyn[:len(dyn) // 2]), 0)}


@pytest.mark.parametrize("name", ["bad_nlen", "reserved_btype",
                                  "header_bits_flipped", "oversubscribed_cl",
                                  "incomplete_cl", "distance_too_far",
                                  "truncated"])
def test_corrupt_blocks_flag_like_reference(name):
    st, off = _corrupt()[name]
    _, _, te, _ = compare(st, [off])
    if name != "header_bits_flipped":
        assert te[0] != 0
