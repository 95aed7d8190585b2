"""Self time of the program's decode.to_device and decode.to_host spans
(the operands to the card, the rows back, the trim and the join) in the
traced window, ms per op: a range read's work follows its window, not
its chunk.  None where the window's ops read no range (no
decode.range_plan span)."""
from codecbench import program

NAMES = ("decode.to_device", "decode.to_host")


def read(ctx):
    snap = program.window()
    if snap is None or "decode.range_plan" not in snap["spans"]:
        return None
    return 1e3 * sum(v["self_s"] for k, v in snap["spans"].items()
                     if program.matches(k, NAMES)) / snap["ops"]
