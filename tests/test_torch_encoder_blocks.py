"""Port vs reference, whole level-2 encode of multi-block inputs: the raw
encoder outputs (stream words, total bits, offsets, bits, full hint
arrays) and the manifest path are identical to deflate_tpu's."""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deflate_tpu.models import encoder as JE
from deflate_tpu.runtime import manifest as JM
from deflate_tpu_torch.models import encoder as E
from deflate_tpu_torch.runtime import manifest as M
from torch_helpers import BLOCK, assert_same, corpus

CASES = {
    "corpus_2_blocks": corpus(2, seed=11),
    "text_over_32k": corpus(1, seed=12)[:BLOCK] + corpus(1, seed=13)[:7232],
    "run_of_a": b"a" * 100000,
    "corpus_4_blocks": corpus(4, seed=14),
}


def _blocks(data: bytes):
    buf = np.frombuffer(data, np.uint8)
    nb = max(1, -(-len(buf) // BLOCK))
    blocks = np.zeros((nb, BLOCK), np.uint8)
    blens = np.zeros(nb, np.int32)
    for i in range(nb):
        chunk = buf[i * BLOCK:(i + 1) * BLOCK]
        blocks[i, :len(chunk)] = chunk
        blens[i] = len(chunk)
    return blocks, blens


@pytest.fixture(scope="module")
def reference():
    """The JAX encoder's raw outputs and manifest per case (one compile
    per block count)."""
    fn = jax.jit(JE.encode_batch_with_hints, static_argnums=(4,))
    out = {}
    for k, data in CASES.items():
        blocks, blens = _blocks(data)
        nb = len(blens)
        raw = fn(jnp.asarray(blocks), jnp.asarray(blens),
                 jnp.ones(nb, bool), np.int32(nb - 1), 2, 0)
        out[k] = ([np.asarray(x) for x in raw],
                  JM.compress_with_manifest(data, level=2))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_raw_encoder_outputs_identical(reference, case):
    data = CASES[case]
    blocks, blens = _blocks(data)
    nb = len(blens)
    got = E.encode_batch_with_hints(
        torch.from_numpy(blocks), torch.from_numpy(blens),
        torch.ones(nb, dtype=torch.bool), nb - 1, 2, 0)
    want, _ = reference[case]
    for g, w, name in zip(got, want, ("words", "total", "offset", "bits",
                                      "hints")):
        assert_same(g, w.view(np.int32) if w.dtype == np.uint32 else w,
                    name)


@pytest.mark.parametrize("case", list(CASES))
def test_manifest_path_identical(reference, case):
    data = CASES[case]
    _, (want_s, want_m) = reference[case]
    got_s, got_m = M.compress_with_manifest(data, level=2, device="cpu")
    assert got_s == want_s
    assert got_m.to_bytes() == want_m.to_bytes()
    assert zlib.decompress(got_s, -15) == data
