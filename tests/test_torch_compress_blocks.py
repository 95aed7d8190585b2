"""Port vs reference, the multi-block encode entry points: ``compress``
of a 9-block input at level 2 (one segment of 9 blocks, where the
reference pads to its 64-block bucket: word text, then random bytes
stored), ``compress_many`` and
``decompress_many`` on tests/test_containers_batch.py's four buffers;
and, in the port only, a 65-block input through ``compress`` (segments
64 | 1, a stored block after a segment that ends at bit phase 4) and
``compress_file`` at its default chunk_blocks, where the reference's
own compress_file raises IndexError (ROADMAP, reference behaviours)."""
import zlib

import numpy as np
import pytest
import torch

import deflate_tpu
import deflate_tpu_torch as D
from deflate_tpu_torch.models import encoder as E
from deflate_tpu_torch.runtime import manifest as M
from torch_helpers import nine_blocks, past_64_blocks


def _plan(data: bytes, level: int):
    """The port's size-only plan of data: (choice, offset) numpy [n]."""
    blocks, blens = M.split_blocks(data)
    choice, _, offset, _ = E.plan_sizes(
        torch.from_numpy(blocks), torch.from_numpy(blens),
        torch.ones(len(blens), dtype=torch.bool), level)
    return choice.numpy(), offset.numpy()


def test_compress_nine_blocks_matches_reference():
    data = nine_blocks()
    choice, _ = _plan(data, 2)
    assert choice.tolist() == [E.CH_DYN] * 6 + [E.CH_STORED] * 3
    got = D.compress(data, 2, device="cpu")
    assert got == deflate_tpu.compress(data, 2)
    # one segment of the 9 blocks, no padding blocks; no words past the
    # stream's bits
    (words, total), = D._encode_segments(np.frombuffer(data, np.uint8), 2,
                                         "cpu")
    assert total == 8 * len(got) - (-total % 8) and words.shape == (9 * E.WB,)
    assert not words[-(-total // 32):].any()
    # the segmented encode gives the one-batch stream
    assert got == M.compress_with_manifest(data, 2, hints=False,
                                           device="cpu")[0]
    assert zlib.decompress(got, -15) == data


def _many_buffers():
    rng = np.random.default_rng(3)
    return [
        b"stream zero " * 300,
        bytes(rng.integers(0, 256, 70000, dtype=np.uint8)),    # 3 blocks
        b"x",
        bytes(rng.integers(97, 123, 40000, dtype=np.uint8)),   # 2 blocks
    ]


def test_compress_many_matches_reference_and_singles():
    bufs = _many_buffers()
    got = D.compress_many(bufs, 2, device="cpu")
    assert got == deflate_tpu.compress_many(bufs, 2)
    for buf, enc in zip(bufs, got):
        assert enc == D.compress(buf, 2, device="cpu")
    assert D.decompress_many(got, device="cpu") \
        == deflate_tpu.decompress_many(got) == bufs


def test_compress_many_resets_the_phase_per_stream():
    """Streams that end at a non-zero bit phase, then a stream whose
    first block is stored: its padding counts from phase 0, not from
    the batch's running offset.  Level 0 and 1 stay cheap."""
    rng = np.random.default_rng(8)
    noise = bytes(rng.integers(0, 256, 3000, dtype=np.uint8))
    bufs = [b"abc" * 7, noise, b"", noise[:999] + b"z" * 40000, noise]
    for level in (0, 1):
        got = D.compress_many(bufs, level, device="cpu")
        for buf, enc in zip(bufs, got):
            assert enc == D.compress(buf, level, device="cpu")
            assert zlib.decompress(enc, -15) == buf


def test_compress_past_64_blocks_and_compress_file(tmp_path):
    data = past_64_blocks()
    choice, offset = _plan(data, 1)
    assert choice[64] == E.CH_STORED and offset[64] & 7 == 4
    got = D.compress(data, 1, device="cpu")
    assert got == M.compress_with_manifest(data, 1, hints=False,
                                           device="cpu")[0]
    src, dst = tmp_path / "in.bin", tmp_path / "out.deflate"
    src.write_bytes(data)
    D.compress_file(str(src), str(dst), level=1, device="cpu")
    assert dst.read_bytes() == got
    assert zlib.decompress(got, -15) == data


@pytest.mark.parametrize("level", [-1, 4])
def test_batch_entry_points_reject_a_bad_level(level, tmp_path):
    src = tmp_path / "in.bin"
    src.write_bytes(b"x")
    for fn in (lambda: D.compress_many([b"x"], level, device="cpu"),
               lambda: D.compress_file(str(src), str(tmp_path / "o"), level,
                                       device="cpu")):
        with pytest.raises(ValueError, match="level must be 0..3"):
            fn()
    with pytest.raises(ValueError, match="level must be 0..3"):
        deflate_tpu.compress_many([b"x"], level)
