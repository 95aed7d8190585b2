"""Self time of the program's encode.split and encode.to_host spans (the
split into blocks and its copies to the card, the copies back, the
stitch and the manifest) in the traced window, ms per MiB of input
(codecbench/program.py)."""
from codecbench import program


def read(ctx):
    return program.self_ms_per_mib(ctx, "encode_to_host")
