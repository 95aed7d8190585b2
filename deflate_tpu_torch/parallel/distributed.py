"""Multi-process distribution for the codec.

Port of deflate_tpu/parallel/distributed.py.  ``init`` joins this
process to a torch.distributed world (one process a device: NCCL on the
card, gloo on the CPU), the global mesh spans every rank, and the
data-parallel encode (parallel/mesh.py) runs unchanged.  Blocks are
independent, so the only traffic between processes is the per-block
size vectors and the final all_reduce of placed words.

The reference simulates several devices in one process on the CPU
(``local_device_count``); torch runs one process a device, so that
count must be None or 1.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from deflate_tpu_torch._build import torch_device
from deflate_tpu_torch.parallel import mesh as M


def init(coordinator_address: str, num_processes: int, process_id: int,
         local_device_count: int | None = None, device="cuda") -> None:
    """Join this process to the world: rank process_id of num_processes,
    meeting at coordinator_address ("host:port", TCP).  device "cuda"
    (NCCL, this rank's card) or "cpu" (gloo)."""
    if local_device_count not in (None, 1):
        raise ValueError(
            f"local_device_count={local_device_count}: torch runs one "
            f"process a device, so each process holds exactly one")
    dev = torch_device(device)
    dist.init_process_group(M.backend_of(dev),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(M.local_rank())


def global_mesh(axis: str = "data"):
    """1-D mesh over every rank of the world, on the device type of the
    world's backend (NCCL: the card, gloo: the CPU)."""
    return M.make_mesh(axis=axis, device=M.world_device())


def compress_distributed(data: bytes, level: int = 2, mesh=None) -> bytes:
    """Compress one buffer data-parallel over the global mesh.  Every
    process passes the SAME data; each encodes its shard of blocks, and
    every process returns the whole raw DEFLATE stream."""
    if mesh is None:
        mesh = global_mesh()
    return M.compress_mesh(data, level, mesh)
