"""Time the program held the host blocked on the card in its spans (the
recorder's wait_s), summed over every span of the traced window's ops,
ms per op: a range read's work follows its window, not its chunk.  None
where the window's ops read no range (no decode.range_plan span)."""
from codecbench import host_account


def read(ctx):
    v = host_account.per_op("wait_s", range_read=True)
    return None if v is None else 1e3 * v
