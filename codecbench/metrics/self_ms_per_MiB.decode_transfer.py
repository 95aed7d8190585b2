"""Self time of the program's decode.to_device and decode.to_host spans
(the operand copies to the card, the results back, the output join) in
the traced window, ms per MiB of output (codecbench/program.py)."""
from codecbench import program


def read(ctx):
    return program.self_ms_per_mib(ctx, "decode_transfer")
