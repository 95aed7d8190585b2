"""Driver entry points: a single-device encode step and a multi-device
dry run.

Port of the JAX package's ``__graft_entry__.py``.  The flagship
pipeline is the DEFLATE encoder (models/encoder.py); its parallelism is
data parallelism over independent blocks plus one replicated integer
scan of bit offsets (parallel/mesh.py).
"""
from __future__ import annotations

import json
import subprocess
import time
import zlib

import numpy as np
import torch

from deflate_tpu_torch._build import torch_device
from deflate_tpu_torch.utils.tables import BLOCK_SIZE


def entry(device="cuda"):
    """(fn, example_args): the level-2 encode of a batch
    (encoder.encode_batch) and two example blocks on `device` (the card
    by default, "cpu" for the plain kernel versions): a quarter block of
    random lowercase text and a full block of random bytes."""
    from deflate_tpu_torch.models import encoder as E

    dev = torch_device(device)

    def fn(blocks, blens, live, final_idx):
        return E.encode_batch(blocks, blens, live, final_idx, 2)

    rng = np.random.default_rng(0)
    B = 2
    blocks = np.zeros((B, BLOCK_SIZE), np.uint8)
    blocks[0, :BLOCK_SIZE // 4] = rng.integers(97, 123, BLOCK_SIZE // 4,
                                               dtype=np.uint8)
    blocks[1] = rng.integers(0, 256, BLOCK_SIZE, dtype=np.uint8)
    blens = np.array([BLOCK_SIZE // 4, BLOCK_SIZE], np.int32)
    live = np.array([True, True])
    example_args = (torch.from_numpy(blocks).to(dev),
                    torch.from_numpy(blens).to(dev),
                    torch.from_numpy(live).to(dev), 1)
    return fn, example_args


def card_label(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    lines = r.stdout.strip().splitlines()
    idx = torch.device(device).index or 0
    return lines[min(idx, len(lines) - 1)] if lines else "unknown card"


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the data-parallel codec over the mesh of the current world,
    which must have n_devices ranks (a world of one is started when no
    process group exists), and check it; every rank calls this.

    Checks: the mesh encode equals the single-program encode_batch; the
    stream round-trips through zlib; decompress_mesh of a v2 manifest
    (the wavefront route) and decode_mesh at the plan's offsets (the scan
    route) give the input back.  Then times the encode of 4 blocks a
    rank by the single program and by the mesh, and returns (and
    prints) the scaling record, with the card and its power limit beside
    the times.  The reference's criterion, a mesh speedup >= 0.8, is
    reported as "passed", not asserted: host time spreads between calls,
    and a timing ratio is no correctness check.  Writes no file."""
    from deflate_tpu_torch.models import encoder as E
    from deflate_tpu_torch.ops.bitpack import words_to_bytes
    from deflate_tpu_torch.ops.inflate_scan import SPAN
    from deflate_tpu_torch.parallel import mesh as M
    from deflate_tpu_torch.runtime import manifest as MF

    mesh = M.make_mesh(device=device)
    if mesh.size() != n_devices:
        raise ValueError(f"need {n_devices} ranks, the world has "
                         f"{mesh.size()}")
    dev = M.mesh_device(mesh)
    me = mesh.get_local_rank()

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def mine(a, per: int):
        return a[me * per:(me + 1) * per]

    rng = np.random.default_rng(1)
    B = n_devices
    blocks = np.zeros((B, BLOCK_SIZE), np.uint8)
    for i in range(B):
        k = 512 * (i + 1)
        blocks[i, :k] = rng.integers(65, 91, k, dtype=np.uint8)
    blens = np.minimum(512 * (np.arange(B, dtype=np.int32) + 1), BLOCK_SIZE)
    live = np.ones((B,), bool)

    words, total = M.encode_mesh(t(mine(blocks, 1)), t(mine(blens, 1)),
                                 t(mine(live, 1)), B - 1, 2, mesh)
    # the sharded result against the single-program encoder
    w1, t1 = E.encode_batch(t(blocks), t(blens), t(live), B - 1, 2)
    a = words_to_bytes(words, total)
    if a != words_to_bytes(w1, t1):
        raise RuntimeError("mesh encode differs from single-program encode")
    raw = b"".join(blocks[i, :blens[i]].tobytes() for i in range(B))
    if zlib.decompress(a, -15) != raw:
        raise RuntimeError("mesh encode round-trip failed")

    # the wavefront decode over the mesh (decode_mesh_wave)
    stream2, man2 = MF.compress_with_manifest(raw, level=2, device=dev)
    if man2.hints is None or M.decompress_mesh(stream2, man2, mesh) != raw:
        raise RuntimeError("mesh wave decode mismatch")

    # the scan decode (the hintless-manifest route) at the plan's offsets
    _, _, offset, _ = E.plan_sizes(t(blocks), t(blens), t(live), 2)
    out, produced, err = M.decode_mesh(
        words, mine(offset, 1), t(mine(blens, 1)), SPAN, BLOCK_SIZE, mesh)
    out = out.cpu().numpy()
    if err or b"".join(out[i, :blens[i]].tobytes()
                       for i in range(B)) != raw:
        raise RuntimeError("mesh scan decode mismatch")

    # ---- scaling: the same blocks by one program and by the mesh ------
    per_dev = 4
    B2 = per_dev * n_devices
    rng2 = np.random.default_rng(2)
    blocks2 = rng2.integers(97, 123, (B2, BLOCK_SIZE), dtype=np.uint8)
    blens2 = np.full((B2,), BLOCK_SIZE, np.int32)
    live2 = np.ones((B2,), bool)
    args = (t(blocks2), t(blens2), t(live2))
    args1 = tuple(x[:per_dev] for x in args)
    shard = tuple(t(mine(x, per_dev)) for x in (blocks2, blens2, live2))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _time(fn, reps=3):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) / reps

    t_single = _time(lambda: E.encode_batch(*args, B2 - 1, 2))
    t_mesh = _time(lambda: M.encode_mesh(*shard, B2 - 1, 2, mesh))
    t_1dev = _time(lambda: E.encode_batch(*args1, per_dev - 1, 2))
    speedup = t_single / t_mesh
    rec = {"n_devices": int(n_devices), "blocks": int(B2),
           "card": card_label(dev),
           "t_single_s": t_single, "t_mesh_s": t_mesh,
           "mesh_speedup_vs_single_program": speedup,
           "pass_criterion": "mesh_speedup_vs_single_program >= 0.8 "
                             "(sharding+collective overhead <= 25%); "
                             "reported, not asserted",
           "passed": bool(speedup >= 0.8),
           "blocks_per_s_1dev": per_dev / t_1dev,
           f"blocks_per_s_{n_devices}dev": B2 / t_mesh}
    print("SCALING", json.dumps(rec), flush=True)
    return rec
