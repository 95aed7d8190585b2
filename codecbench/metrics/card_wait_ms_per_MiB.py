"""Time the program held the host blocked on the card in its spans (the
recorder's wait_s: copies across, the stream synchronise), summed over
every span of the traced window's ops, ms per MiB of input
(codecbench/host_account.py).  Read for every split of the quantity:
card_wait_ms_per_MiB.encode and card_wait_ms_per_MiB.decode."""
from codecbench import host_account


def read(ctx):
    v = host_account.per_mib(ctx, "wait_s")
    return None if v is None else 1e3 * v
