"""Port vs reference, the file and range entry points on the inputs of
tests/test_runtime_files.py and tests/test_runtime.py:
``compress_file`` with small chunks (several chunks, the bit tail
carried across them) writes deflate_tpu's bytes, which equal
``compress``; ``decompress_file`` (host) gives the same files, also for
blocks that span its read boundary, and the same InflateError on a
truncated stream; ``decode_range`` gives the same bytes on every range
of test_runtime.py's manifest."""
import zlib

import numpy as np
import pytest

import deflate_tpu
import deflate_tpu_torch as D
from deflate_tpu.runtime import manifest as JM
from deflate_tpu_torch.runtime import manifest as M


def test_compress_file_streaming_matches_reference(tmp_path):
    rng = np.random.default_rng(17)
    pat = rng.integers(0, 230, 1013, dtype=np.uint8)
    data = np.tile(pat, 150)[: 4 * 32768 + 7777].tobytes()
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    ours, theirs = tmp_path / "ours.deflate", tmp_path / "theirs.deflate"
    D.compress_file(str(src), str(ours), level=2, chunk_blocks=2,
                    device="cpu")
    deflate_tpu.compress_file(str(src), str(theirs), level=2,
                              chunk_blocks=2)
    enc = ours.read_bytes()
    assert enc == theirs.read_bytes()
    assert enc == D.compress(data, 2, device="cpu")
    assert zlib.decompress(enc, -15) == data


def _decompress_both(tmp_path, stream: bytes, chunk_bytes: int):
    src = tmp_path / "in.z"
    src.write_bytes(stream)
    ours, theirs = tmp_path / "ours.bin", tmp_path / "theirs.bin"
    D.decompress_file(str(src), str(ours), chunk_bytes=chunk_bytes)
    deflate_tpu.decompress_file(str(src), str(theirs),
                                chunk_bytes=chunk_bytes)
    out = ours.read_bytes()
    assert out == theirs.read_bytes()
    return out


def test_decompress_file_of_a_level3_file(tmp_path):
    data = b"file roundtrip " * 9000
    src, mid = tmp_path / "a.bin", tmp_path / "a.deflate"
    src.write_bytes(data)
    D.compress_file(str(src), str(mid), level=3, device="cpu")
    assert _decompress_both(tmp_path, mid.read_bytes(), 1 << 23) == data


def test_decompress_file_block_spans_read_boundary(tmp_path):
    rng = np.random.default_rng(11)
    data = (b"boundary " * 20000
            + rng.integers(0, 256, 100000, dtype=np.uint8).tobytes()) * 3
    assert _decompress_both(tmp_path, zlib.compress(data, 6)[2:-4],
                            4096) == data


def test_decompress_file_cross_block_history(tmp_path):
    data = bytes(range(256)) * 600
    assert _decompress_both(tmp_path, zlib.compress(data, 9)[2:-4],
                            8192) == data


def test_decompress_file_truncated_raises(tmp_path):
    data = b"will be cut" * 5000
    st = zlib.compress(data, 6)[2:-4]
    src = tmp_path / "in.z"
    src.write_bytes(st[: len(st) // 2])
    with pytest.raises(D.InflateError) as ours:
        D.decompress_file(str(src), str(tmp_path / "o"), chunk_bytes=2048)
    with pytest.raises(deflate_tpu.InflateError) as theirs:
        deflate_tpu.decompress_file(str(src), str(tmp_path / "t"),
                                    chunk_bytes=2048)
    assert str(ours.value) == str(theirs.value)


def _runtime_data():
    """tests/test_runtime.py's input: text, a repeated phrase, random."""
    rng = np.random.default_rng(9)
    return b"".join([rng.integers(97, 123, 40000, dtype=np.uint8).tobytes(),
                     b"seekable! " * 4000,
                     rng.integers(0, 256, 50000, dtype=np.uint8).tobytes()])


@pytest.fixture(scope="module")
def stream_and_manifest():
    data = _runtime_data()
    stream, man = M.compress_with_manifest(data, level=2, device="cpu")
    return data, stream, man


@pytest.mark.parametrize("rng", [(0, 100), (32760, 32800), (65536, 98304),
                                 (100000, 130000), (0, 10**9),
                                 (131000, 131000), (139999, 140001)])
def test_decode_range_matches_reference(stream_and_manifest, rng):
    data, stream, man = stream_and_manifest
    start, end = rng
    got = M.decode_range(stream, man, start, end, device=None)
    jman = JM.Manifest.from_bytes(man.to_bytes())
    assert got == JM.decode_range(stream, jman, start, end)
    assert got == data[start:min(end, len(data))]
