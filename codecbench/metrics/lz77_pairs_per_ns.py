"""(position, candidate) pairs find_matches compares per ns of its
passes in the traced window: the program's lz77.pairs counter (positions
x chain depth, once a pass, whatever implements the search) over the
self time of its lz77.chain and lz77.tier spans."""
from codecbench import program

PASSES = ("lz77.chain", "lz77.tier")


def read(ctx):
    snap = program.window()
    if snap is None:
        return None
    pairs = snap["counts"].get("lz77.pairs")
    self_s = sum(snap["spans"][k]["self_s"] for k in PASSES
                 if k in snap["spans"])
    if not pairs or self_s <= 0:
        return None
    return pairs / (1e9 * self_s)
