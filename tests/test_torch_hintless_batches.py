"""decode_all without hints (models/block_decoder.inflate_manifest over
ops/block_inflate.inflate_batches) on the CPU: streams of more than one
256-block batch, with a short last block and stored blocks among
dynamic ones, decode to their bytes; nothing is pinned or copied on the
CPU; and the staged operands equal those the stream's blocks were
always given (window arithmetic, avail cap, zero tail)."""
import zlib

import numpy as np
import pytest

from deflate_tpu_torch.models import block_decoder as BD
from deflate_tpu_torch.models import host_inflate as HI
from deflate_tpu_torch.ops import block_inflate as BI
from deflate_tpu_torch.runtime import manifest as M
from deflate_tpu_torch.utils import metrics
from torch_helpers import BLOCK


def _bits(b: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(b, np.uint8), bitorder="little")


def _pieces():
    """Three distinct full dynamic blocks and a short one (the port's
    encoder, level 2), and a block of random bytes to store: (bits,
    data) each, the stored block's bits None."""
    rng = np.random.default_rng(27)
    datas = []
    for n in (509, 317, 1021):
        pat = bytes(rng.integers(97, 123, n, dtype=np.uint8))
        datas.append((pat * (BLOCK // n + 1))[:BLOCK])
    datas.append(datas[1][:4000])
    stream, man = M.compress_with_manifest(b"".join(datas), level=2,
                                           hints=False, device="cpu")
    assert [b[2] for b in man.blocks] == [len(d) for d in datas]
    bits = _bits(stream)
    out = [(bits[off:off + bl], d) for (off, bl, _), d in zip(man.blocks,
                                                               datas)]
    return out + [(None, bytes(rng.integers(0, 256, BLOCK,
                                             dtype=np.uint8)))]


def tiled_manifest(nblocks: int):
    """A hintless manifest stream of nblocks independent blocks, laid bit
    by bit: the dynamic pieces in turn, a stored block every 97th, the
    short piece last.  Returns (stream, Manifest, data)."""
    pieces = _pieces()
    seq = [4 if i % 97 == 40 else i % 3 for i in range(nblocks - 1)] + [3]
    parts, blocks, data, pos = [], [], [], 0
    for i, k in enumerate(seq):
        bits, d = pieces[k]
        if bits is None:                    # stored: pad to a byte
            n = len(d)
            bits = np.concatenate([
                np.zeros(3 + (-(pos + 3)) % 8, np.uint8),
                _bits(n.to_bytes(2, "little")
                      + (n ^ 0xFFFF).to_bytes(2, "little") + d)])
        else:
            bits = bits.copy()
        bits[0] = i == nblocks - 1          # BFINAL
        parts.append(bits)
        blocks.append((pos, len(bits), len(d)))
        data.append(d)
        pos += len(bits)
    stream = np.packbits(np.concatenate(parts), bitorder="little").tobytes()
    return stream, M.Manifest(BLOCK, pos, blocks), b"".join(data)


def _no_host(*a, **kw):
    raise AssertionError("a block took the host decoder")


@pytest.mark.parametrize("nblocks", [257, 513])
def test_hintless_decode_of_more_than_one_batch(nblocks, monkeypatch):
    stream, man, data = tiled_manifest(nblocks)
    assert zlib.decompress(stream, -15) == data
    assert sum(b[2] == BLOCK for b in man.blocks) == nblocks - 1
    launches = []
    real = BI.inflate_rows

    def spy(words, start_w, *rest):
        launches.append(start_w.shape[0])
        return real(words, start_w, *rest)

    monkeypatch.setattr(BI, "inflate_rows", spy)
    monkeypatch.setattr(HI, "inflate_raw", _no_host)
    metrics.reset()
    out = BD.inflate_manifest(stream, man.blocks, device="cpu")
    assert type(out) is bytes and out == data
    got = M.decode_all(stream, man, device="cpu")
    assert type(got) is bytes and got == data
    per_call = [BD.BATCH] * (nblocks // BD.BATCH) + [nblocks % BD.BATCH]
    assert launches == per_call * 2
    c = metrics.snapshot()["counts"]
    assert c["decode.path.pallas_scalar"] == 1
    assert not [k for k in c if k.startswith("copy.")]


def _prepare_blocks_unstaged(stream: bytes, bit_offsets):
    """The operands as prepare_blocks computed them in one function,
    before the stream's words and the blocks' windows were staged
    apart."""
    nbits = len(stream) * 8
    offs = np.asarray(bit_offsets, np.int64)
    start_w = ((offs // 32) // 1024 * 1024).astype(np.int64)
    bit0 = (offs - 32 * start_w).astype(np.int32)
    avail = np.minimum(nbits - 32 * start_w,
                       (BI.IN_W - 3) * 32).astype(np.int32)
    pad = (-len(stream)) % 4
    words = np.frombuffer(stream + b"\x00" * pad, np.uint8).view(np.int32)
    words = np.concatenate([words, np.zeros(BI.IN_W + 8, np.int32)])
    return words, start_w.astype(np.int32), bit0, avail


@pytest.mark.parametrize("tail", [0, 1, 2, 3])
def test_staged_operands_near_the_stream_end(tail):
    """Blocks whose window reaches past the cap of (IN_W - 3) words and
    blocks near the stream's end, whose window runs into the zero tail,
    for stream lengths of every residue mod 4."""
    rng = np.random.default_rng(tail)
    stream = bytes(rng.integers(0, 256, 3 * 4 * BI.IN_W + tail,
                                dtype=np.uint8))
    nbits = 8 * len(stream)
    offs = [0, 5, 32 * 1024 - 1, 32 * 1024, 32 * 2048 + 77,
            nbits - 32 * BI.IN_W, nbits - 300, nbits - 3, nbits - 1]
    want = _prepare_blocks_unstaged(stream, offs)
    got = BI.prepare_blocks(stream, offs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert (g == w).all()
    assert (want[3][:2] == (BI.IN_W - 3) * 32).all()
    assert (want[3][-3:] < (BI.IN_W - 3) * 32).all()
    staged = BI.stream_words(stream)
    assert not staged.is_pinned()
    assert (staged.numpy() == want[0]).all()
