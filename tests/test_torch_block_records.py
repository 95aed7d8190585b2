"""Port vs reference, kernel K6's design: inflate_blocks_records (each
block decoded to its literal row and match records, then filled by K4's
pointer jumping) returns the same rows, status and err flags as
inflate_blocks_plain and as deflate_tpu's inflate_blocks (Pallas
interpret mode) — on this package's own multi-block stream, a
fixed-Huffman block, the corrupt blocks of test_torch_block_inflate.py,
and single blocks of 258-byte matches at distance 1 and at distance
32768 - 258."""
import numpy as np
import pytest
import torch

from deflate_tpu.ops import pallas_inflate as PI
from deflate_tpu_torch.ops import block_inflate as BI
from deflate_tpu_torch.runtime import manifest as M
from test_torch_block_inflate import _cases, _corrupt
from torch_helpers import assert_same, corpus, long_match_streams

CORRUPT = ["bad_nlen", "reserved_btype", "header_bits_flipped",
           "oversubscribed_cl", "incomplete_cl", "distance_too_far",
           "truncated"]


def _stream(name):
    """(stream, block bit offsets) of a named case."""
    if name == "own_multiblock":
        data = corpus(3, seed=51)[:3 * 32768 - 999]
        stream, man = M.compress_with_manifest(data, level=2, hints=False,
                                               device="cpu")
        return stream, [b[0] for b in man.blocks]
    if name == "fixed":
        return _cases()["fixed"], [0]
    if name in CORRUPT:
        st, off = _corrupt()[name]
        return st, [off]
    return long_match_streams()[name], [0]


@pytest.mark.parametrize("name", ["own_multiblock", "fixed", *CORRUPT,
                                  "dist_1", "dist_32510"])
def test_records_decomposition_matches_plain_and_reference(name):
    stream, offs = _stream(name)
    words, start_w, bit0, avail = BI.prepare_blocks(stream, offs)
    ops = [torch.from_numpy(x)
           for x in (words, start_w, bit0, avail, BI.make_statics())]
    ro, rs = BI.inflate_blocks_records(*ops)
    po, ps = BI.inflate_blocks_plain(*ops)
    jo, jp, je, jb = PI.inflate_blocks(stream, offs, interpret=True)
    err = rs[:, 1].numpy()
    assert_same(err, ps[:, 1], "err vs plain")
    assert ((err != 0) == (np.asarray(je) != 0)).all(), "err vs reference"
    ok = err == 0
    assert_same(rs[ok], ps[ok], "status vs plain")
    assert_same(ro[ok], po[ok], "rows vs plain")
    end = 32 * start_w.astype(np.int64) + rs[:, 2].numpy()
    assert (rs[ok, 0].numpy() == np.asarray(jp)[ok]).all(), "produced"
    assert (end[ok] == np.asarray(jb)[ok]).all(), "end bit"
    rows = ro.numpy().view(np.uint8)
    for b in np.nonzero(ok)[0]:
        n = int(rs[b, 0])
        assert (rows[b, :n] == np.asarray(jo)[b, :n]).all(), b
        assert not rows[b, n:].any(), b
    if name in ("own_multiblock", "fixed", "dist_1", "dist_32510"):
        assert ok.all()
    elif name != "header_bits_flipped":
        assert not ok.any()
