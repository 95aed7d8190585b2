"""Self time of the program's wave.* spans (resolve_litval,
merge_match_runs) in the traced window, ms per MiB of output
(codecbench/program.py)."""
from codecbench import program


def read(ctx):
    return program.self_ms_per_mib(ctx, "wave_glue")
