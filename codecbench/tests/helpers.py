"""Shared pieces of the benchmark's CPU tests."""
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the cells' files, BENCHMARK.json's cells and those held back
CELLS = ["archive-l2.write", "archive-l2.read", "bare-deflate.write",
         "bare-deflate.read"]
# two 32 KiB blocks, the second partial: the cells' paths at a size the
# port's plain kernel versions run in seconds on the CPU
TINY = {"chunk_bytes": 40000, "pool": 2}
