"""95th percentile (nearest rank) of every op's latency in the window,
all ops pooled, in ms."""
from codecbench.yardstick import p95


def read(ctx):
    return 1e3 * p95([o.t1 - o.t0 for o in ctx.ops])
