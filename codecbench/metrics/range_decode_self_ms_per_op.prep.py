"""Self time of the program's decode.range_plan, decode.headers and
decode.windows spans (the range's blocks found, cut from the stream and
given their hint rows; the header parse; the windows and the bucket
pack) in the traced window, ms per op: a range read's work follows its
window, not its chunk.  None where the window's ops read no range (no
decode.range_plan span)."""
from codecbench import program

NAMES = ("decode.range_plan", "decode.headers", "decode.windows")


def read(ctx):
    snap = program.window()
    if snap is None or "decode.range_plan" not in snap["spans"]:
        return None
    return 1e3 * sum(v["self_s"] for k, v in snap["spans"].items()
                     if program.matches(k, NAMES)) / snap["ops"]
