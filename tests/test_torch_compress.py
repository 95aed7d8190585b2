"""Port vs reference, ``compress`` on the device path at levels 0-3, on
empty input (one block of length 0) and on one byte: the same bytes as
deflate_tpu.compress (each level compiles the reference's one-block
batch once), and python zlib reads them."""
import zlib

import pytest

import deflate_tpu
import deflate_tpu_torch as D

INPUTS = {"empty": b"", "one_byte": b"\xa7"}


@pytest.mark.parametrize("name", list(INPUTS))
@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_compress_matches_reference(level, name):
    data = INPUTS[name]
    got = D.compress(data, level, device="cpu")
    assert got == deflate_tpu.compress(data, level)
    assert zlib.decompress(got, -15) == data


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_compress_uint8_array_like_bytes(level):
    """A uint8 array compresses like its bytes; another dtype is a
    TypeError in both packages."""
    import numpy as np

    a = np.frombuffer(INPUTS["one_byte"], np.uint8)
    assert D.compress(a, level, device="cpu") \
        == D.compress(INPUTS["one_byte"], level, device="cpu")
    with pytest.raises(TypeError):
        D.compress(a.astype(np.int16), level, device="cpu")
    with pytest.raises(TypeError):
        deflate_tpu.compress(a.astype(np.int16), level)
