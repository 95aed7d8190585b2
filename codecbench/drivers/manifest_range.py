"""Entry: runtime/manifest.decode_range(stream, manifest, start, end,
device), a log archive read by time range.

Set-up writes each pool chunk once with compress_with_manifest at the
configuration's level and hints, and indexes it by time as a log store
does beside its archive: the second of every whole line and the byte
where the line starts.  The windows are drawn then too, from a generator
seeded from the chunk's bytes (a driver gets no seed; the pool is made
from it): a length from ``range_windows_s`` with ``range_window_weights``,
a start uniform over the chunk's time span less the length, and the byte
bounds of the lines inside.  Each call on chunk i reads chunk i's next
window; an output is (start, end, bytes returned).

decode_range decodes a block that the device path flags on the host,
through models/host_inflate.inflate_raw; a counting pass-through around
it, installed from here, counts those blocks, and an op with any fails:
the call asked for the card.  A program whose decode_range takes no
device fails in prepare, before any set-up encode.

The judgement: every held output against the chunk's bytes [start, end);
the first held output and CHECKED - 1 more drawn from the pool's bytes
against reference/range.py, decoding the window's blocks from their bit
offsets in the stream; each chunk's manifest against the stream, as the
write cells judge it.
"""
from __future__ import annotations

import datetime
import inspect
import zlib

import numpy as np

from codecbench import judge
from codecbench.reference import range as reference
from codecbench.trace import Patches

WINDOWS = 8192          # windows drawn a chunk; its calls take them in turn
CHECKED = 8             # held outputs decoded again by the reference
WINDOW_STREAM = 0x57494E44
PICK_STREAM = 0x5049434B
MONTHS = b"JanFebMarAprMayJunJulAugSepOctNovDec"
EPOCH = datetime.date(1970, 1, 1).toordinal()


def line_index(chunk: bytes):
    """(seconds int64 [n], starts int64 [n + 1]) of a chunk of Combined
    Log Format lines: each whole line's time ("[dd/Mon/yyyy:HH:MM:SS
    +0000]", the line's first "["), in seconds since 1970, and the byte
    where it starts; last, the byte after the last whole line."""
    a = np.frombuffer(chunk, np.uint8)
    starts = np.concatenate([[0], np.flatnonzero(a == ord("\n")) + 1])
    brackets = np.flatnonzero(a == ord("["))
    stamp = a[brackets[np.searchsorted(brackets, starts[:-1])][:, None]
              + np.arange(1, 21)].astype(np.int64)

    def num(lo, hi):
        out = np.zeros(len(stamp), np.int64)
        for k in range(lo, hi):
            out = 10 * out + stamp[:, k] - ord("0")
        return out
    name = (stamp[:, 3] << 16) | (stamp[:, 4] << 8) | stamp[:, 5]
    month = np.zeros(len(stamp), np.int64)
    for m in range(12):
        month[name == int.from_bytes(MONTHS[3 * m:3 * m + 3], "big")] = m + 1
    dates, back = np.unique(num(7, 11) * 10000 + month * 100 + num(0, 2),
                            return_inverse=True)
    ordinal = np.array([datetime.date(d // 10000, d // 100 % 100,
                                      d % 100).toordinal() - EPOCH
                        for d in dates.tolist()], np.int64)
    seconds = (86400 * ordinal[back] + 3600 * num(12, 14) + 60 * num(15, 17)
               + num(18, 20))
    return seconds, starts


def windows(seconds, starts, lengths, weights, n: int, rng):
    """Byte bounds (lo, hi) int64 [n] of n time windows: a length drawn
    from lengths by weights, a start uniform over the time span less the
    length, the lines from the first at or after the start to the last
    before its end."""
    w = np.asarray(weights, np.float64)
    length = np.asarray(lengths, np.float64)[rng.choice(len(w), n,
                                                        p=w / w.sum())]
    t0 = seconds[0] + rng.random(n) * np.maximum(
        seconds[-1] - seconds[0] - length, 0)
    return (starts[np.searchsorted(seconds, t0)],
            starts[np.searchsorted(seconds, t0 + length)])


def cover(blocks, lo, hi):
    """For byte bounds lo, hi (int64 [n]) of a stream's output: the blocks
    that hold them (i0, i1), the stream bytes from the first one's to the
    one that holds the last one's last bit, and the bytes they decode to."""
    b = np.asarray(blocks, np.int64).reshape(-1, 3)
    begin = np.concatenate([[0], np.cumsum(b[:, 2])])
    i0 = np.searchsorted(begin[1:], lo, "right")
    i1 = np.searchsorted(begin[:-1], hi, "left")
    last_bit = b[i1 - 1, 0] + b[i1 - 1, 1]
    return i0, i1, -(-last_bit // 8) - b[i0, 0] // 8, begin[i1] - begin[i0]


class Input:
    """A pool chunk written in set-up, and its windows."""

    def __init__(self, stream, man, lo, hi):
        self.stream, self.man = stream, man
        self.lo, self.hi = lo.tolist(), hi.tolist()
        i0, i1, span, decoded = cover(man.blocks, lo, hi)
        # each window's blocks, their stream bytes, the bytes they decode
        # to and the bytes returned
        self.sizes = {"blocks": i1 - i0, "stream_bytes": span,
                      "bytes_decoded": decoded, "bytes_returned": hi - lo}
        self.calls = 0

    def next(self) -> tuple[int, int]:
        j = self.calls % len(self.lo)
        self.calls += 1
        return self.lo[j], self.hi[j]


class Driver:
    def __init__(self, config: dict, device):
        from deflate_tpu_torch.runtime import manifest

        self.manifest = manifest
        self.config = config
        self.device = device
        self.inputs: list[Input] = []
        self.host_blocks = 0
        self.patches = Patches()

        def count(orig):
            def wrapper(*a, **k):
                self.host_blocks += 1
                return orig(*a, **k)
            return wrapper
        self.patches.wrap("deflate_tpu_torch.models.host_inflate",
                          "inflate_raw", count)

    def prepare(self, chunks):
        if "device" not in inspect.signature(
                self.manifest.decode_range).parameters:
            raise RuntimeError(
                "runtime/manifest.decode_range takes no device: this "
                "program reads a range on the host alone")
        cfg = self.config
        for chunk in chunks:
            stream, man = self.manifest.compress_with_manifest(
                chunk, level=cfg["level"], hints=cfg["hints"],
                device=self.device)
            seconds, starts = line_index(chunk)
            rng = np.random.default_rng((zlib.crc32(chunk), WINDOW_STREAM))
            lo, hi = windows(seconds, starts, cfg["range_windows_s"],
                             cfg["range_window_weights"], WINDOWS, rng)
            self.inputs.append(Input(stream, man, lo, hi))
        return self.inputs

    def call(self, inp: Input):
        start, end = inp.next()
        before = self.host_blocks
        out = self.manifest.decode_range(inp.stream, inp.man, start, end,
                                         device=self.device)
        n = self.host_blocks - before
        return (start, end, out), (f"{n} blocks decoded on the host" if n
                                   else None)

    def faulty(self, fault, inp: Input):
        (start, end, out), note = self.call(inp)
        if fault == "unchanged":              # the window's stream bytes
            i0, i1, _, _ = cover(inp.man.blocks, np.array([start]),
                                 np.array([end]))
            b = inp.man.blocks
            out = inp.stream[b[i0[0]][0] // 8:
                             -(-(b[i1[0] - 1][0] + b[i1[0] - 1][1]) // 8)]
        elif fault == "half":
            out = out[:len(out) // 2]
        else:
            out = judge.flip(out)
        return (start, end, out), note

    def out_bytes(self, out) -> int:
        return len(out[2])

    def io_bytes(self, inp: Input, out) -> int:
        """The stream bytes of the window's blocks read, the bytes they
        decode to written."""
        _, _, span, decoded = cover(inp.man.blocks, np.array([out[0]]),
                                    np.array([out[1]]))
        return int(span[0] + decoded[0])

    def judge(self, chunks, ops):
        lost = sum(o.lost for o in ops)
        held = [o for o in ops if o.out is not None]
        wrong = sum(o.out[2] != chunks[o.index][o.out[0]:o.out[1]]
                    for o in held)
        crc = 0
        for c in chunks:
            crc = zlib.crc32(c, crc)
        rest = max(len(held) - 1, 0)
        drawn = np.random.default_rng((crc, PICK_STREAM)).choice(
            rest, min(CHECKED - 1, rest), replace=False)
        picks = held[:1] + [held[1 + k] for k in sorted(drawn)]
        unlike = 0
        for o in picks:
            inp = self.inputs[o.index]
            start, end, out = o.out
            try:
                ref = reference.decode_range(inp.stream, inp.man.blocks,
                                             start, end)
            except ValueError:
                ref = None
            unlike += out != ref
        seen = sorted({o.index for o in held})
        spec = {"block_size": self.config["block_size"],
                "hints": self.config["hints"]}
        faults = judge._map_faults([
            (self.inputs[i].stream, chunks[i], spec,
             judge._plain(self.inputs[i].man)) for i in seen])
        bad = {i for i, f in zip(seen, faults) if f["stream"]
               or f["manifest"]}
        return {"ops_lost": (lost, 0), "ops_wrong": (wrong, 0),
                "ops_unlike_reference": (unlike, 0),
                "manifests_wrong": (sum(o.index in bad for o in held), 0)}

    def detail(self, inputs, ops) -> dict:
        """The means a read over every call of the process (warm-up,
        window and profiled ones): the windows' blocks, their stream
        bytes, the bytes they decode to and the bytes returned."""
        calls = sum(inp.calls for inp in inputs)
        taken = [np.arange(inp.calls) % WINDOWS for inp in inputs]
        means = {f"mean_{k}": sum(int(inp.sizes[k][t].sum()) for inp, t
                                  in zip(inputs, taken)) / max(calls, 1)
                 for k in inputs[0].sizes}
        return {"stream_bytes": sum(len(inputs[o.index].stream)
                                    for o in ops),
                "host_blocks_in_process": self.host_blocks,
                "range": {"calls": calls, **means,
                          "reference_checked": min(CHECKED, sum(
                              o.out is not None for o in ops))}}

    def close(self):
        self.patches.undo()
