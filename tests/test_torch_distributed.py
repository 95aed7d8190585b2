"""Port vs reference, multi-process encode (deflate_tpu_torch/parallel/
distributed.py): two spawned processes join one gloo world through
distributed.init at 127.0.0.1 and run compress_distributed on
tests/test_distributed.py's 330,000-byte input; four more join through
a FileStore and run it on the global mesh.  Every process's stream must
equal the reference's compress_mesh stream for that input (8-device CPU
mesh).  The reference simulates several devices per process; torch runs
one process a device, so init refuses local_device_count > 1."""
import socket

import jax
import numpy as np
import pytest

from deflate_tpu.parallel import mesh as JM
from deflate_tpu_torch.parallel import distributed as DD
from torch_helpers import run_ranks


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    return (rng.integers(97, 123, 200000, dtype=np.uint8).tobytes()
            + bytes(50000)
            + rng.integers(0, 256, 80000, dtype=np.uint8).tobytes())


@pytest.fixture(scope="module")
def reference(data):
    return JM.compress_mesh(data, 2, JM.make_mesh(jax.devices()[:8]))


def test_two_process_init_and_compress(tmp_path, data, reference):
    got = run_ranks(tmp_path, 2, "distributed", data, port=_free_port())
    assert [g["world"] for g in got] == [2, 2]
    assert [g["device"] for g in got] == ["cpu", "cpu"]
    for g in got:
        assert g["stream"] == reference


def test_four_rank_global_mesh_compress(tmp_path, data, reference):
    got = run_ranks(tmp_path, 4, "distributed", data)
    assert [g["world"] for g in got] == [4] * 4
    for g in got:
        assert g["stream"] == reference


@pytest.mark.parametrize("count", [0, 2, 4])
def test_init_refuses_more_than_one_local_device(count):
    with pytest.raises(ValueError, match="one process a device"):
        DD.init("127.0.0.1:1", 1, 0, local_device_count=count,
                device="cpu")
