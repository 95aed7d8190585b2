"""Chunk bytes decoded by the window's ops (10^6 bytes) over the window's
seconds, from the first call to the return of the last."""


def read(ctx):
    return ctx.mb_per_s
