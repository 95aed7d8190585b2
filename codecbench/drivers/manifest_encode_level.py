"""Entry: runtime/manifest.compress_with_manifest(chunk, level, hints,
device), judged as manifest_encode judges it, and held to its level.

The level check (``streams_over_level``, limit 0): for each pool chunk
with a judged output, ``level_check_blocks`` of its 32 KiB blocks are
drawn by a generator seeded from the chunk's bytes (so from the run's
seed), and the plain level-3 reference (reference/level3.py) sizes them
on the device, once per chunk, after the window.  An output fails when
the bits its manifest gives those blocks (the judge has checked them
against the stream) sum to more than ``ratio_ceiling`` times the
reference's: a stream that a weaker search wrote is larger by more than
the port's departures from the reference.
"""
from __future__ import annotations

import time
import zlib

import numpy as np

from codecbench import harness, judge
from codecbench.reference import level3

# reference blocks sized at once: ~3 GB of the card's memory
BATCH = 256


class Driver(harness.load("drivers", "manifest_encode").Driver):
    def __init__(self, config: dict, device):
        super().__init__(config, device)
        self.ceiling = config["ratio_ceiling"]
        self.sample = config["level_check_blocks"]
        self.block_size = config["block_size"]
        self.ratios: list[float] = []
        self.check_s = 0.0

    def picks(self, chunk: bytes) -> np.ndarray:
        """The blocks of chunk that the check sizes, in order."""
        nblocks = -(-len(chunk) // self.block_size)
        rng = np.random.default_rng(zlib.crc32(chunk))
        return np.sort(rng.choice(nblocks, min(self.sample, nblocks),
                                  replace=False))

    def reference_bits(self, chunk: bytes, picks) -> float:
        """The reference's bits for the picked blocks of chunk."""
        import torch

        n = self.block_size
        buf = np.zeros(len(picks) * n, np.uint8).reshape(len(picks), n)
        blens = np.zeros(len(picks), np.int64)
        for row, b in enumerate(picks):
            part = np.frombuffer(chunk[b * n:(b + 1) * n], np.uint8)
            buf[row, :len(part)] = part
            blens[row] = len(part)
        total = 0.0
        for s in range(0, len(picks), BATCH):
            blk = torch.from_numpy(buf[s:s + BATCH]).to(self.device)
            bl = torch.from_numpy(blens[s:s + BATCH]).to(self.device)
            total += float(level3.block_bits(blk, bl).sum())
        return total

    def judge(self, chunks, ops):
        checks = super().judge(chunks, ops)
        t = time.perf_counter()
        over = 0
        self.ratios = []
        for i, outs in judge._distinct(ops).items():
            picks = self.picks(chunks[i])
            ref = self.reference_bits(chunks[i], picks)
            nblocks = -(-len(chunks[i]) // self.block_size)
            for (_, man), members in outs:
                if man is None or len(man.blocks) != nblocks:
                    over += len(members)
                    continue
                ratio = sum(man.blocks[b][1] for b in picks) / ref
                self.ratios.append(ratio)
                over += len(members) * (ratio > self.ceiling)
        self.check_s = time.perf_counter() - t
        checks["streams_over_level"] = (over, 0)
        return checks

    def detail(self, inputs, ops) -> dict:
        return {**super().detail(inputs, ops),
                "level_check": {"ratios": self.ratios,
                                "ceiling": self.ceiling,
                                "blocks": self.sample,
                                "seconds": self.check_s}}
