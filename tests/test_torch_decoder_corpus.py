"""Port vs reference, wavefront device decode of four benchmark-corpus
blocks (text, repeats, words, random: three span buckets and a stored
block): words, produced counts and error flags are identical to
deflate_tpu's inflate_wave_device (Pallas kernels in interpret mode).
A file of its own, so that its reference compiles run on their own
test worker."""
import numpy as np

from test_torch_decoder import _compare, _encoded
from torch_helpers import corpus


def test_inflate_wave_device_identical_corpus():
    stream, offs, sizes, hints, data = _encoded(corpus(4, seed=32))
    words, produced, err = _compare(stream, offs, sizes, hints)
    assert not err.any()
    w = words.view(np.uint8).reshape(len(offs), -1)
    assert b"".join(w[b, :produced[b]].tobytes()
                    for b in range(len(offs))) == data
