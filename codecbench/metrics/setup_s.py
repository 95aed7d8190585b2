"""Seconds from the start of the process to the first timed op: imports,
the CUDA context, loading or building the kernels, the pool, the set-up
encodes and the warm-up."""


def read(ctx):
    return ctx.setup_s
