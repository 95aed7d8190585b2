"""Share of the HBM roofline over the path's kernels, in %: the least time
the card needs to move the bytes the path must move (each input byte
read once, each output byte written once, whatever implements the path;
the entry driver's io_bytes) at the published HBM bandwidth, over the
summed device time of the kernels in the profiled slice (copies and
memsets left out).  Read for every split of the quantity:
kernels_roofline.encode and kernels_roofline.decode."""
from codecbench.yardstick import HBM_BYTES_PER_S


def read(ctx):
    peak = HBM_BYTES_PER_S.get(ctx.device_kind)
    if ctx.profile is None or peak is None or ctx.profile["kernel"] <= 0:
        return None
    return 100 * (ctx.io_bytes / peak) / ctx.profile["kernel"]
