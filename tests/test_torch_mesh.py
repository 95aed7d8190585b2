"""Port vs reference, data-parallel encode (deflate_tpu_torch/parallel/
mesh.py against deflate_tpu/parallel/mesh.py): compress_mesh at levels 0
and 2, through CodecConfig, and encode_mesh at a nonzero phase0, on 1, 2
and 4 gloo ranks (spawned processes, tests/torch_helpers.run_ranks)
against the reference's 8-device CPU mesh.  The streams and words must
be identical on every rank."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deflate_tpu.parallel import mesh as JM
from torch_helpers import mk_blocks, run_ranks

WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def inputs():
    """A 7-block input of _mk_blocks-style blocks (padded to 8 blocks on
    2 and 4 ranks) and 8 blocks for encode_mesh."""
    b7, l7 = mk_blocks(7, np.random.default_rng(8))
    data = b"".join(b7[i, :l7[i]].tobytes() for i in range(7))
    blocks, blens = mk_blocks(8, np.random.default_rng(7))
    return data, blocks, blens


@pytest.fixture(scope="module")
def reference(inputs):
    data, blocks, blens = inputs
    mesh = JM.make_mesh(jax.devices()[:8])
    out = {}
    for level in (0, 2):
        out[f"compress{level}"] = JM.compress_mesh(data, level, mesh)
        w, total = JM.encode_mesh(
            jnp.asarray(blocks), jnp.asarray(blens), jnp.ones(8, bool),
            jnp.int32(7), level, mesh, phase0=5)
        out[f"phase5_{level}"] = (np.asarray(w), int(total))
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"{w}ranks")
def ranks(request, inputs, tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("mesh"), request.param,
                     "encode", *inputs)


def test_mesh_spans_the_world(ranks):
    assert [r["world"] for r in ranks] == [len(ranks)] * len(ranks)
    assert all(r["axis"] == ("data",) for r in ranks)


@pytest.mark.parametrize("level", [0, 2])
def test_compress_mesh_matches_reference(ranks, reference, level):
    for r in ranks:
        assert r[f"compress{level}"] == reference[f"compress{level}"]


@pytest.mark.parametrize("level", [0, 2])
def test_encode_mesh_phase0_matches_reference(ranks, reference, level):
    jw, jt = reference[f"phase5_{level}"]
    for r in ranks:
        w, total = r[f"phase5_{level}"]
        assert total == jt
        assert np.array_equal(w.view(np.uint32), jw.view(np.uint32))


def test_compress_mesh_reads_config(ranks, reference):
    """config.level (0) overrides the level argument (2), and a mesh on
    config.mesh_axis is made when none is given."""
    for r in ranks:
        assert r["config"] == reference["compress0"]
