"""Self time of the program's decode.block_inflate span in the traced
window: K6's inflate of a stream's blocks on the card (launch to the
synchronised end), ms per MiB of output, as codecbench/program.py
reckons its splits."""
from codecbench import program

NAME = "decode.block_inflate"


def read(ctx):
    snap = program.window()
    if snap is None or NAME not in snap["spans"]:
        return None
    mib_per_op = ctx.work_bytes / len(ctx.ops) / 2 ** 20
    return 1e3 * snap["spans"][NAME]["self_s"] / snap["ops"] / mib_per_op
