"""Self time of the program's lz77.* spans (find_matches, greedy_parse) in
the traced window, ms per MiB of input (codecbench/program.py)."""
from codecbench import program


def read(ctx):
    return program.self_ms_per_mib(ctx, "lz77")
