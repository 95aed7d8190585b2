"""The project's mixed synthetic corpus, frozen here for the benchmark.

Four equal parts: random lowercase letters (literals with short matches),
a repeated 509-byte pattern (long matches), random 6-character words of
printable ASCII each followed by two spaces (literals with two-byte gaps),
and random bytes (stored blocks).  The bytes equal those of the corpus
every earlier card number of the project was measured on, for the same
generator; the words part is built in one vectorised step.
"""
from __future__ import annotations

import numpy as np


def make_corpus(rng: np.random.Generator, nbytes: int) -> bytes:
    per = nbytes // 4
    text = rng.integers(97, 123, per, dtype=np.uint8)
    pat = rng.integers(0, 256, 509, dtype=np.uint8)
    repeats = np.tile(pat, per // 509 + 1)[:per]
    words = rng.integers(32, 127, (per // 8, 6), dtype=np.uint8)
    words = np.concatenate(
        [words, np.full((len(words), 2), 32, np.uint8)], axis=1).ravel()[:per]
    rand = rng.integers(0, 256, nbytes - 3 * per, dtype=np.uint8)
    return np.concatenate([text, repeats, words, rand]).tobytes()


def make_pool(seed: int, pool: int, chunk_bytes: int) -> list[bytes]:
    """Chunk i of the pool is make_corpus(default_rng((seed, i)))."""
    return [make_corpus(np.random.default_rng((seed, i)), chunk_bytes)
            for i in range(pool)]
