"""Data-parallel DEFLATE over a torch.distributed device mesh.

Port of deflate_tpu/parallel/mesh.py.  Blocks are independent (every
block this package's encoder emits is self-contained), so the codec's
only parallelism is over blocks, on mesh axis ``data``:

  stage A  (sharded)    each rank plans its blocks: LZ77 parse,
                        histograms, trees (kernel K1 on the card), sizes
  stage B  (replicated) all_gather the per-block candidate sizes (a few
                        bytes a block) and run the exact block-type /
                        bit-offset scan on every rank
  stage C  (sharded)    each rank emits its blocks' chosen encoding
  stage D  (collective) each rank places its blocks' words at their bit
                        offsets in a zeroed int32 buffer (ops/bitmerge.
                        place_words); one all_reduce (SUM) gives the
                        stream on every rank (the bits of different
                        blocks are disjoint, so no carry arises and the
                        sum is their OR, the sign bit included).

Where JAX runs one program over the devices of a mesh (shard_map),
torch runs one process a device: every function here runs on each rank
of the mesh with that rank's shard and returns the replicated result.
The mesh is a 1-D ``DeviceMesh`` over the ranks of the default process
group: NCCL on the card, gloo on the CPU.  When no process group
exists, ``make_mesh`` starts a world of one through a ``FileStore`` in
a temporary directory, so no network is needed.

No rank raises before a collective the others enter: a rank whose local
work fails still takes part in every collective with zeroed outputs,
every rank reduces the error flags, and then every rank raises.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from deflate_tpu_torch._build import torch_device
from deflate_tpu_torch.models import encoder as E
from deflate_tpu_torch.ops import bitmerge as BM
from deflate_tpu_torch.utils import tables as T
from deflate_tpu_torch.utils.bits import I32, I64

AXIS = "data"


def backend_of(device) -> str:
    """The collective backend of a device type: NCCL on the card, gloo
    on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_rank() -> int:
    """This process's card on its host: LOCAL_RANK when a launcher set
    it, else the rank modulo the host's card count."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() % max(1, torch.cuda.device_count())


def _world_of_one(backend: str) -> None:
    tmp = tempfile.mkdtemp(prefix="deflate_mesh_")
    atexit.register(shutil.rmtree, tmp, True)
    store = dist.FileStore(os.path.join(tmp, "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)


def make_mesh(devices=None, axis: str = AXIS, device="cuda"):
    """A 1-D DeviceMesh over every rank of the default process group,
    named (axis,), starting a world of one when no group exists.

    devices: None, or the ranks of the world in order (a mesh spans the
    whole world: torch runs one process a device).  device: "cuda" (the
    card of this rank, NCCL) or "cpu" (gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch_device(device)
    if not dist.is_initialized():
        _world_of_one(backend_of(dev))
    world = dist.get_world_size()
    if devices is not None and list(devices) != list(range(world)):
        raise ValueError(f"a mesh spans every rank of the world "
                         f"({world}), one process a device; got {devices}")
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank())
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(axis,))


def world_device() -> str:
    """The device type of the current world: "cpu" in a gloo world, else
    "cuda" (an NCCL world, or none yet)."""
    if dist.is_initialized() and dist.get_backend() != "nccl":
        return "cpu"
    return "cuda"


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _group(mesh):
    return mesh.get_group(mesh.mesh_dim_names[0])


def _gather(t: torch.Tensor, mesh) -> torch.Tensor:
    """all_gather along dim 0 (tiled) over the mesh's axis."""
    parts = [torch.empty_like(t) for _ in range(mesh.size())]
    dist.all_gather(parts, t.contiguous(), group=_group(mesh))
    return torch.cat(parts)


def _count_all(n, mesh, dev) -> int:
    """The sum over ranks of a local count."""
    t = torch.tensor([int(n)], dtype=I32, device=dev)
    dist.all_reduce(t, group=_group(mesh))
    return int(t.item())


def _guarded(fn, fallback):
    """fn() or, when it raises, (fallback(), the exception): the rank
    still enters the collectives after it."""
    try:
        return fn(), None
    except Exception as e:                       # noqa: BLE001
        return fallback(), e


def encode_mesh(blocks, blens, live, final_idx: int, level: int, mesh,
                phase0: int = 0):
    """Encode B blocks data-parallel over `mesh` into one bitstream.

    Called on every rank with that rank's shard: blocks uint8 [Bl, 32768],
    blens int32 [Bl], live bool [Bl] (B = Bl x mesh size, rank r holding
    rows r*Bl..(r+1)*Bl-1); final_idx: global index of the BFINAL block;
    phase0: the segment's absolute bit offset in the stream.  Returns
    (words int32 [B*WB], total_bits int) on every rank."""
    ndev = mesh.size()
    me = mesh.get_local_rank()
    Bl = blocks.shape[0]
    B = Bl * ndev
    dev = blocks.device

    plans = E.batch_plan(blocks, blens, level)
    # stage B: gather the tiny per-block size vectors, scan everywhere
    fb = _gather(plans["fixed_bits"].to(I32), mesh)
    db = _gather(plans["dyn_bits"].to(I32), mesh)
    bl = _gather(blens.to(I32), mesh)
    lv = _gather(live.to(I32), mesh) > 0
    choice, pad, offset, bits = E.choose_blocks(fb, db, bl, lv, level,
                                                phase0)
    offset = offset - phase0                   # segment-relative placement

    lo = me * Bl
    mine = slice(lo, lo + Bl)
    bfinal = (lo + torch.arange(Bl, device=dev)) == final_idx
    # stage C: emit local blocks
    words = E.emit_block(blocks, blens, plans, choice[mine], pad[mine],
                         bfinal)
    words = torch.where(live[:, None], words, 0)
    # stage D: place at the segment's bit offsets, combine across ranks
    seg = BM.place_words(words, offset[mine], B * E.WB)
    dist.all_reduce(seg, group=_group(mesh))
    return seg, int(bits.to(I64).sum())


def _shard(a: np.ndarray, mesh) -> np.ndarray:
    Bl = len(a) // mesh.size()
    me = mesh.get_local_rank()
    return a[me * Bl:(me + 1) * Bl]


def compress_mesh(data: bytes, level: int = 2, mesh=None,
                  config=None) -> bytes:
    """Compress one buffer data-parallel over a mesh; every rank passes
    the same data and gets the whole raw DEFLATE stream.

    config: a ``CodecConfig``; supplies level and the mesh axis name
    (config.mesh_axis) when no mesh is given."""
    from deflate_tpu_torch.ops.bitpack import words_to_bytes

    if config is not None:
        level = config.level
    if mesh is None:
        mesh = make_mesh(axis=config.mesh_axis if config is not None
                         else AXIS, device=world_device())
    ndev = mesh.size()
    dev = mesh_device(mesh)
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    nblocks = max(1, -(-len(buf) // T.BLOCK_SIZE))
    B = -(-nblocks // ndev) * ndev                 # pad to mesh multiple
    blocks = np.zeros((B, T.BLOCK_SIZE), np.uint8)
    blens = np.zeros((B,), np.int32)
    for i in range(nblocks):
        chunk = buf[i * T.BLOCK_SIZE:(i + 1) * T.BLOCK_SIZE]
        blocks[i, :len(chunk)] = chunk
        blens[i] = len(chunk)
    live = np.arange(B) < nblocks

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(_shard(a, mesh))).to(dev)

    words, total = encode_mesh(t(blocks), t(blens), t(live), nblocks - 1,
                               level, mesh)
    return words_to_bytes(words, total)


def decode_mesh(words, starts, out_lens, span: int, out_cap: int, mesh):
    """Data-parallel decode of manifest-indexed blocks over `mesh`.

    Blocks from this package's encoder are self-contained, so with a
    manifest giving each block's bit offset every rank decodes its shard
    of blocks (models/decoder.decode_block_standalone, torch code, one
    block a call) and the outputs all_gather back in order.

    Called on every rank: words int32 [W], the whole stream; starts int32
    [Bl], this rank's blocks' bit offsets; out_lens int32 [Bl], their
    expected output bytes (0: a padding slot).  Returns (out uint8
    [B, out_cap], produced int32 [B], error bool) on every rank."""
    from deflate_tpu_torch.models import decoder as DEC

    dev = words.device
    Bl = starts.shape[0]

    def local():
        res = [DEC.decode_block_standalone(words, s, span, out_cap)
               for s in starts]
        if not res:
            return (torch.zeros((0, out_cap), dtype=torch.uint8, device=dev),
                    torch.zeros(0, dtype=I32, device=dev),
                    torch.zeros(0, dtype=torch.bool, device=dev))
        out, produced, err = zip(*res)
        return (torch.stack(out), torch.stack(produced).to(I32),
                torch.stack(err))

    (out, produced, err), exc = _guarded(local, lambda: (
        torch.zeros((Bl, out_cap), dtype=torch.uint8, device=dev),
        torch.zeros(Bl, dtype=I32, device=dev),
        torch.ones(Bl, dtype=torch.bool, device=dev)))
    live = out_lens > 0
    bad = live & (err | (produced != out_lens))
    out_all = _gather(out, mesh)
    produced_all = _gather(produced * live, mesh)
    nbad = _count_all(int(bad.sum()) + (exc is not None), mesh, dev)
    if exc is not None:
        raise exc
    return out_all, produced_all, nbad > 0


def decode_mesh_wave(nw, hints, sizes, stored, md, W64: int, mesh):
    """Data-parallel wavefront decode over `mesh`: every rank runs stages
    A-F (K2 or K8, K3) and the match fill (K4) on its shard of
    manifest-indexed self-contained blocks; outputs all_gather back.

    Called on every rank with its rows: nw int32 [Bl, 2*W64+4]
    normalized windows; hints int32 [Bl, W64]; sizes int32 [Bl] expected
    bytes (0: a padding row); stored bool [Bl] (window passthrough); md:
    dict of int32 tensors (ops/wave.parse_headers_host's keys).  Returns
    (words int32 [B, OW], produced int32 [B], err_any bool) on every
    rank."""
    from deflate_tpu_torch.ops import wave as W
    from deflate_tpu_torch.ops import wave_fill as WF

    dev = nw.device
    Bl = nw.shape[0]

    def local():
        litw, r0, r1, nm, prod, e = W.wave_decode(nw, hints, sizes, md, W64)
        win = nw[:, :2 * W64 + 4]
        if 2 * W64 + 4 < WF.OW:
            win = torch.nn.functional.pad(win, (0, WF.OW - (2 * W64 + 4)))
        litw = torch.where(stored[:, None], win[:, :WF.OW], litw)
        recs = WF.pack_fill_recs(r0, r1)
        nm = torch.where(stored, 0, nm)
        prod = torch.where(stored, sizes, prod)
        e = torch.where(stored, 0, e)
        return WF.fill_matches(litw, recs, nm), prod.to(I32), e

    (filled, prod, e), exc = _guarded(local, lambda: (
        torch.zeros((Bl, WF.OW), dtype=I32, device=dev),
        torch.zeros(Bl, dtype=I32, device=dev),
        torch.ones(Bl, dtype=I32, device=dev)))
    live = sizes > 0
    bad = live & ((e > 0) | (prod != sizes))
    out_all = _gather(filled, mesh)
    prod_all = _gather(prod * live, mesh)
    nbad = _count_all(int(bad.sum()) + (exc is not None), mesh, dev)
    if exc is not None:
        raise exc
    return out_all, prod_all, nbad > 0


def decompress_mesh_wave(stream: bytes, manifest, mesh=None) -> bytes:
    """Wavefront decode of a hint-carrying (v2) manifest stream over a
    mesh.  Raises ValueError on every rank on corruption (a header parse
    error, wave chain validation or a produced-count mismatch)."""
    from deflate_tpu_torch.models.wave_decoder import BUCKETS, \
        MD_DEVICE_KEYS
    from deflate_tpu_torch.ops import wave as W

    if mesh is None:
        mesh = make_mesh(device=world_device())
    dev = mesh_device(mesh)
    ndev = mesh.size()
    nb = len(manifest.blocks)
    # padded to the world size only; the reference pads to ndev x its TPU
    # fill kernel's cell of rows (the bytes are the same)
    B = -(-nb // ndev) * ndev
    offs = np.zeros(B, np.int64)
    sizes = np.zeros(B, np.int64)
    spans = np.zeros(B, np.int64)
    for i, (off, bl, olen) in enumerate(manifest.blocks):
        offs[i], spans[i], sizes[i] = off, bl, olen
    # padding rows parse block 0's header and pass through as stored
    # blocks of length 0
    md = W.parse_headers_host(stream, offs)
    stored = (md["btype"] == 0) | (np.arange(B) >= nb)
    hdr_err = np.asarray(md["hdr_err"]) & (np.arange(B) < nb)
    harr = manifest.hint_array()
    if harr is None:
        harr, _ = W.hints_from_walk_host(stream, offs[:nb])
    # one window size for the whole mesh: the smallest bucket that holds
    # the largest block
    need = int(np.maximum(spans - (md["data_start"] - offs), 1).max()
               + 63) // 64 + 1
    W64 = next((b for b in BUCKETS if b >= need), BUCKETS[-1])
    nw = W.prepare_windows(stream, md["data_start"], W64)
    hints = np.full((B, W64), W.HINT_NONE, np.uint8)
    hav = min(W64, harr.shape[1])
    hints[:nb, :hav] = harr[:, :hav]

    def t(a, dtype=np.int32):
        return torch.from_numpy(np.ascontiguousarray(_shard(a, mesh),
                                                     dtype)).to(dev)

    # every rank has parsed every header; each reduces its shard's flags
    # before the decode, whose collectives every rank then enters
    hdr_bad = _count_all(int(_shard(hdr_err, mesh).sum()), mesh, dev)
    out, produced, err = decode_mesh_wave(
        t(nw), t(hints), t(sizes), t(stored, np.bool_),
        {k: t(md[k]) for k in MD_DEVICE_KEYS}, W64, mesh)
    if err or hdr_bad:
        raise ValueError("mesh wave decode failed (corrupt stream or "
                         "manifest)")
    w = out.cpu().numpy().view(np.uint8).reshape(B, -1)
    produced = produced.cpu().numpy()
    return b"".join(w[i, :produced[i]].tobytes() for i in range(nb))


def decompress_mesh(stream: bytes, manifest, mesh=None) -> bytes:
    """Decode a manifest-indexed stream over a mesh.

    v2 manifests (decode hints) take the wavefront decoder
    (decompress_mesh_wave); hintless v1 manifests the scan decoder
    (decode_mesh).  Raises ValueError on every rank on corruption."""
    if getattr(manifest, "hints", None) is not None:
        return decompress_mesh_wave(stream, manifest, mesh)

    from deflate_tpu_torch.ops.bitpack import bytes_to_words
    from deflate_tpu_torch.ops.inflate_scan import SPAN

    if mesh is None:
        mesh = make_mesh(device=world_device())
    dev = mesh_device(mesh)
    ndev = mesh.size()
    nb = len(manifest.blocks)
    B = -(-nb // ndev) * ndev
    starts = np.zeros((B,), np.int32)
    out_lens = np.zeros((B,), np.int32)
    for i, (off, _, olen) in enumerate(manifest.blocks):
        starts[i] = off
        out_lens[i] = olen
    # span bucketing: the manifest knows every block's compressed size, so
    # the token-scan span shrinks to the largest block
    max_bits = max(b[1] for b in manifest.blocks)
    span = SPAN
    for cand in (1 << 14, 1 << 16):
        if max_bits + 64 <= cand:
            span = cand + 64
            break
    words, _ = bytes_to_words(stream)
    out, produced, err = decode_mesh(
        torch.from_numpy(words.view(np.int32)).to(dev),
        torch.from_numpy(_shard(starts, mesh).copy()).to(dev),
        torch.from_numpy(_shard(out_lens, mesh).copy()).to(dev),
        span, T.BLOCK_SIZE, mesh)
    if err:
        raise ValueError("mesh decode failed (corrupt stream or manifest)")
    out = out.cpu().numpy()
    produced = produced.cpu().numpy()
    return b"".join(out[i, :produced[i]].tobytes() for i in range(nb))
