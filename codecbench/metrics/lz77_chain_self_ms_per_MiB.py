"""Self time of the program's lz77.chain span in the traced window: the
3-byte hash-chain pass of find_matches (48 deep at level 3), ms per MiB
of input, as codecbench/program.py reckons its splits."""
from codecbench import program

NAME = "lz77.chain"


def read(ctx):
    snap = program.window()
    if snap is None or NAME not in snap["spans"]:
        return None
    mib_per_op = ctx.work_bytes / len(ctx.ops) / 2 ** 20
    return 1e3 * snap["spans"][NAME]["self_s"] / snap["ops"] / mib_per_op
