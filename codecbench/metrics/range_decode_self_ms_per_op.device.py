"""Self time of the program's decode.stages, decode.fill and wave.*
spans (stages A-F of the wavefront decode: K2, K3, K11, K12 and the
torch between them; the match fill, K4), synchronised, in the traced
window, ms per op: a range read's work follows its window, not its
chunk.  None where the window's ops read no range (no decode.range_plan
span)."""
from codecbench import program

NAMES = ("decode.stages", "decode.fill", "wave.")


def read(ctx):
    snap = program.window()
    if snap is None or "decode.range_plan" not in snap["spans"]:
        return None
    return 1e3 * sum(v["self_s"] for k, v in snap["spans"].items()
                     if program.matches(k, NAMES)) / snap["ops"]
