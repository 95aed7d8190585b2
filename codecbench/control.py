"""The controls of `correct`, run on the card at a cell's own size.

    python3 -m codecbench.control --workload <name> --seeds 1,2,3 \
        --seconds 5 [--faults unchanged,half,flip]

For each seed: the cell's set-up and warm-up as in a measured run, then
for each fault a short closed loop with that fault planted in what the
entry returns, and the same judgement as a measured run.  Each fault has
to come out not correct:

- flip: one byte in the middle of each output inverted, the guarantee
  that every answer is exact broken (the control);
- unchanged: the entry runs, and returns its input as its output;
- half: a write encodes the first half of its chunk, a read returns the
  first half of its output.

One JSON line per seed and fault, with every check beside its limit.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    from codecbench import harness

    ap = argparse.ArgumentParser(prog="codecbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--faults", default=",".join(harness.FAULTS))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("codecbench.control: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    caught = True
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(cell, seed, dev)
        run.warm()
        for fault in args.faults.split(","):
            ops = run.loop(args.seconds, fault=fault)
            checks = run.judge(ops)
            correct = harness.verdict(checks, ops)
            caught &= not correct
            print(json.dumps({
                "workload": cell.name, "seed": seed, "fault": fault,
                "ops": len(ops), "correct": correct,
                "checks": {k: {"value": v, "limit": lim}
                           for k, (v, lim) in checks.items()}}), flush=True)
        run.close()
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
