"""The comparisons that decide `correct`, and the faults that must fail
them.

Once the window has closed, every op that raised counts as lost, and
every output held is judged: a share of the window's ops drawn from the
seed (harness.HELD_SHARE) and every op after it.  Ops of one pool chunk
usually return equal outputs, so each distinct output of a chunk is
judged once and its verdict holds for every op that returned it.

- A stream (write cells) is right when the benchmark's own decoder
  (reference/inflate.py) decodes it to the chunk, ending in its last
  byte, and Python's zlib does the same: the stream is plain RFC 1951
  that any zlib reads.  A manifest is right when its block size is the
  configuration's and its block table equals the one the reference works
  out from the stream, and its entry phases equal the reference's where
  the configuration asks for hints and are absent where it does not.
- Decoded bytes (read cells) are right when they equal the chunk the
  benchmark made.

Each check is a count of ops with limit 0: the comparisons are exact.
The reference decodes ~1 µs a symbol, seconds for a stream of MiBs, so
the distinct streams of a run are judged in a few processes at once.
"""
from __future__ import annotations

import multiprocessing
import types
import zlib
from concurrent.futures import ProcessPoolExecutor

from codecbench.reference.inflate import inflate

# streams judged in worker processes when a run's distinct streams hold
# more bytes than this
PARALLEL_BYTES = 4 << 20
WORKERS = 4


def _distinct(ops):
    """{chunk index: [(output, [ops])]}, equal outputs together."""
    groups: dict = {}
    for o in ops:
        if o.out is None:
            continue
        seen = groups.setdefault(o.index, [])
        for out, members in seen:
            if out == o.out:
                members.append(o)
                break
        else:
            seen.append((o.out, [o]))
    return groups


def stream_faults(stream: bytes, chunk: bytes, spec: dict | None = None,
                  manifest=None) -> dict:
    """{"stream", "zlib", "manifest"}: True where that part of one output
    is wrong.  spec, for a write with a manifest: the configuration's
    "block_size" and "hints"."""
    bad = {"stream": False, "zlib": False, "manifest": False}
    blocks, end = None, 0
    want_phases = spec is not None and spec["hints"]
    try:
        out, blocks = inflate(stream, want_phases=want_phases,
                              max_out=len(chunk))
        end = blocks[-1].bit_offset + blocks[-1].bit_len
        bad["stream"] = out != chunk or -(-end // 8) != len(stream)
    except (ValueError, IndexError):
        bad["stream"] = True
    try:
        d = zlib.decompressobj(-15)
        bad["zlib"] = (d.decompress(stream) + d.flush() != chunk
                       or not d.eof or d.unused_data != b"")
    except zlib.error:
        bad["zlib"] = True
    if spec is not None:
        bad["manifest"] = (
            blocks is None or manifest is None
            or manifest.block_size != spec["block_size"]
            or manifest.total_bits != end
            or [tuple(b) for b in manifest.blocks]
            != [(b.bit_offset, b.bit_len, b.out_len) for b in blocks]
            or manifest.hints != ([b.phases for b in blocks] if want_phases
                                  else None))
    return bad


def _plain(man):
    """The parts of a manifest the judge reads, as plain values that pass
    to a worker process without the program."""
    if man is None:
        return None
    return types.SimpleNamespace(
        block_size=man.block_size, total_bits=man.total_bits,
        blocks=[tuple(b) for b in man.blocks],
        hints=None if man.hints is None else list(man.hints))


def _faults(args):
    return stream_faults(*args)


def _map_faults(items: list) -> list:
    """stream_faults over (stream, chunk, spec, manifest) tuples."""
    if len(items) < 2 or sum(len(a[0]) for a in items) <= PARALLEL_BYTES:
        return [_faults(a) for a in items]
    with ProcessPoolExecutor(
            max_workers=min(WORKERS, len(items)),
            mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(_faults, items))


def judge_streams(chunks, ops, spec: dict | None = None) -> dict:
    """Checks of a write cell: ops whose stream (and, given the manifest's
    spec, manifest) is wrong."""
    lost = sum(o.lost for o in ops)
    wrong = {"stream": 0, "zlib": 0, "manifest": 0}
    any_wrong = 0
    items, groups = [], []
    for i, outs in _distinct(ops).items():
        for out, members in outs:
            if spec is not None:
                items.append((out[0], chunks[i], spec, _plain(out[1])))
            else:
                items.append((out, chunks[i], None, None))
            groups.append(members)
    for members, bad in zip(groups, _map_faults(items)):
        for k in wrong:
            wrong[k] += len(members) * bad[k]
        any_wrong += len(members) * any(bad.values())
    checks = {"ops_lost": (lost, 0), "ops_wrong": (any_wrong, 0),
              "streams_wrong": (wrong["stream"], 0),
              "zlib_wrong": (wrong["zlib"], 0)}
    if spec is not None:
        checks["manifests_wrong"] = (wrong["manifest"], 0)
    return checks


def judge_decoded(chunks, ops) -> dict:
    """Checks of a read cell: ops whose bytes differ from the chunk."""
    lost = sum(o.lost for o in ops)
    wrong = sum(o.out is not None and o.out != chunks[o.index] for o in ops)
    return {"ops_lost": (lost, 0), "ops_wrong": (wrong, 0)}


def flip(buf: bytes) -> bytes:
    """One byte in the middle of buf inverted: an answer altered where it
    is produced."""
    b = bytearray(buf)
    if b:
        b[len(b) // 2] ^= 0xFF
    return bytes(b)
