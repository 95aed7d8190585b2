"""Self time of the program's decode.skeleton, decode.headers and
decode.windows spans (the skeleton walk, the header parse, the windows
and the bucket pack) in the traced window, ms per MiB of output
(codecbench/program.py)."""
from codecbench import program


def read(ctx):
    return program.self_ms_per_mib(ctx, "decode_prep")
