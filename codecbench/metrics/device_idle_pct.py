"""Share of the profiled slice in which nothing ran on the card, in %:
100 x (1 - the union of kernel and copy intervals / the slice's wall
time).  Read for every split of the quantity: device_idle_pct.encode
and device_idle_pct.decode."""


def read(ctx):
    if ctx.profile is None:
        return None
    return 100 * (1 - ctx.profile["busy"] / ctx.profile["window"])
