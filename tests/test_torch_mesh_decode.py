"""Port vs reference, data-parallel decode (deflate_tpu_torch/parallel/
mesh.py's decompress_mesh against deflate_tpu's): a v2 manifest takes
the wavefront route (decode_mesh_wave: stages A-F and the match fill)
and a hintless one the scan route (decode_mesh: decode_block_standalone
a block), on 1, 2 and 4 gloo ranks against the reference on a 1-device
CPU mesh; and TestFaultInjection's corrupted stream raises ValueError on
every rank of both routes, with no rank left hanging (each spawned rank
has its own timeout)."""
import jax
import numpy as np
import pytest

from deflate_tpu.parallel import mesh as JM
from deflate_tpu.runtime import manifest as JMF
from deflate_tpu_torch.runtime import manifest as MF
from torch_helpers import corrupt_block3, run_ranks

WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def inputs():
    """6 blocks (tests/test_mesh.py's decode input): random lowercase
    text, a repeated phrase and random bytes (stored blocks)."""
    rng = np.random.default_rng(21)
    data = b"".join([rng.integers(97, 123, 60000, dtype=np.uint8).tobytes(),
                     b"mesh decode! " * 5000,
                     rng.integers(0, 256, 40000, dtype=np.uint8).tobytes()])
    stream, man = MF.compress_with_manifest(data, level=2, device="cpu")
    hstream, hman = MF.compress_with_manifest(data, level=2, hints=False,
                                              device="cpu")
    assert man.hints is not None and hman.hints is None
    return data, stream, man.to_bytes(), hstream, hman.to_bytes()


@pytest.fixture(scope="module")
def reference(inputs):
    _, stream, mb, hstream, hmb = inputs
    mesh = JM.make_mesh(jax.devices()[:1])
    man, hman = JMF.Manifest.from_bytes(mb), JMF.Manifest.from_bytes(hmb)
    out = {"wave": JM.decompress_mesh(stream, man, mesh),
           "scan": JM.decompress_mesh(hstream, hman, mesh)}
    for key, s, m in (("wave", stream, man), ("scan", hstream, hman)):
        with pytest.raises(ValueError):
            JM.decompress_mesh(corrupt_block3(s, m), m, mesh)
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"{w}ranks")
def ranks(request, inputs, tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("mesh_decode"), request.param,
                     "decode", *inputs[1:])


@pytest.mark.parametrize("route", ["wave", "scan"])
def test_decompress_mesh_matches_reference(ranks, reference, inputs, route):
    assert reference[route] == inputs[0]
    for r in ranks:
        assert r[route] == reference[route]


def test_v2_manifests_take_the_wave_route(ranks):
    """A spy on decompress_mesh_wave: called once for the v2 manifest,
    never for the hintless one."""
    assert all(r["wave_route_calls"] == (1, 0) for r in ranks)


@pytest.mark.parametrize("route", ["wave", "scan"])
def test_corrupt_stream_raises_on_every_rank(ranks, reference, route):
    assert [r[f"corrupt_{route}"] for r in ranks] == \
        ["ValueError"] * len(ranks)
