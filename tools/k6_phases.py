"""Where kernel K6's time goes inside a block, at phase C's operands of
chip_smoke.py (its 8 MiB corpus: quarters of lowercase text, 509-byte
repeats, 6-letter words and random bytes, 64 blocks each).

    python3 tools/k6_phases.py

Copies deflate_tpu_torch into deflate_tpu_torch/_build/k6_phases/ (a
build directory .gitignore lists) and adds to its csrc/block_inflate.cu
timestamps of the device's global timer at the end of each phase of a
block (stage, header and tables, fast tables, symbol loop, fill) and
cycle counters in the symbol loop (clock64 around each match), stored in
the unused tail of each block's record scratch.  The counters cost a few
cycles a match, so the loop runs slightly slower than the kernel itself.
Prints the card's name and power limit, then one JSON line: per quarter,
the mean and max over its blocks of each phase in µs, and for the symbol
loop the SM clock (cycles per ns), literal steps, matches, cycles per
literal step (the loop's cycles outside matches over its literal steps)
and cycles per match.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(ROOT, "deflate_tpu_torch", "_build", "k6_phases")
PHASES = ("stage", "header_tables", "fast_tables", "symbol_loop", "fill")
QUARTERS = ("text", "repeats", "words", "random")
DBG = 11200                     # first unused record slot (<= 10922 used)



def gtime(var: str) -> str:
    return f'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"({var}));'


def stamp(k: int) -> str:
    """Thread 0 stores the time since the block's start in dbg[k]."""
    return ("if (threadIdx.x == 0) { unsigned long long t; " + gtime("t")
            + f" dbg[{k}] = (long long)(t - T0); }}")


# (anchor, replacement) pairs; each anchor must occur exactly once
KERNEL_EDITS = [
    ("  const int b = blockIdx.x;\n",
     "  const int b = blockIdx.x;\n  unsigned long long T0;\n  "
     + gtime("T0") + "\n  long long* dbg = reinterpret_cast<"
     "long long*>(recs_all + (int64_t)b * fill::NM + " + str(DBG) + ");\n"),
    ("    tabs[i] = statics[i];\n  __syncthreads();\n",
     "    tabs[i] = statics[i];\n  __syncthreads();\n  "
     + stamp(0) + "\n"),
    ("  const int mode = st[S_MODE];\n",
     "  " + stamp(1) + "\n  const int mode = st[S_MODE];\n"),
    ("    build_fast(tabs, fast, dfast);\n    __syncthreads();\n",
     "    build_fast(tabs, fast, dfast);\n    __syncthreads();\n    "
     + stamp(2) + "\n"),
    ("  const int produced = st[S_OPOS]",
     "  " + stamp(3) + "\n  const int produced = st[S_OPOS]"),
    ("out + (int64_t)b * OUT_W);\n",
     "out + (int64_t)b * OUT_W);\n  __syncthreads();\n  "
     + stamp(4) + "\n"),
    ("&opos, &nm);", "&opos, &nm, dbg);"),
    ("int* opos_out, int* nm_out) {\n",
     "int* opos_out, int* nm_out, long long* dbg) {\n  long long c0 = "
     "clock64(), cm = 0, nl = 0, nmat = 0;\n  unsigned long long g0;\n  "
     + gtime("g0") + "\n"),
    ("      opos += lit ? (fe >> 24) & 3 : 0;\n",
     "      opos += lit ? (fe >> 24) & 3 : 0;\n      nl += lit;\n"),
    ("    int k, nb, eb, base;\n",
     "    const long long ca = clock64();\n    int k, nb, eb, base;\n"),
    ("    wbase += sh << 5;\n  }\n",
     "    wbase += sh << 5;\n    cm += clock64() - ca;\n    nmat++;\n  }\n"
     "  {\n    unsigned long long g1;\n    " + gtime("g1")
     + "\n    dbg[5] = clock64() - c0;\n    dbg[6] = cm;\n    dbg[7] = nl;"
     "\n    dbg[8] = nmat;\n    dbg[9] = (long long)(g1 - g0);\n  }\n"),
]
WRAPPER_EDIT = ('        _build.check(err, "dt_inflate_blocks")\n',
                '        _build.check(err, "dt_inflate_blocks")\n'
                '        global last_recs\n        last_recs = recs\n')


def patch(path: str, edits) -> None:
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"k6_phases: {path} has {src.count(old)} "
                               f"copies of {old!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k6_phases: no CUDA device", file=sys.stderr)
        return 2
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "deflate_tpu_torch"),
                    os.path.join(COPY, "deflate_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    pkg = os.path.join(COPY, "deflate_tpu_torch")
    patch(os.path.join(pkg, "csrc", "block_inflate.cu"), KERNEL_EDITS)
    patch(os.path.join(pkg, "ops", "block_inflate.py"), [WRAPPER_EDIT])
    sys.path.insert(0, ROOT)
    sys.path.insert(0, COPY)
    from chip_smoke import CORPUS_BYTES, SEED, make_corpus
    from deflate_tpu_torch.ops import block_inflate as BI
    from deflate_tpu_torch.runtime import manifest as M

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    data = make_corpus(np.random.default_rng(SEED), CORPUS_BYTES)
    hs, hm = M.compress_with_manifest(data, level=2, hints=False, device=dev)
    ops = [torch.from_numpy(x).to(dev) for x in
           (*BI.prepare_blocks(hs, [b[0] for b in hm.blocks]),
            BI.make_statics())]
    for _ in range(3):
        out, status = BI.inflate_blocks_kernel(*ops)
    torch.cuda.synchronize()
    if int(status[:, 1].abs().sum()) or int(status[:, 0].sum()) != len(data):
        raise RuntimeError("k6_phases: the instrumented K6 does not decode")
    dbg = BI.last_recs.view(torch.int64).reshape(status.shape[0], -1)
    dbg = dbg[:, DBG:DBG + 10].cpu().numpy().astype(np.float64)
    res = {"card": card, "quarters": []}
    for q, name in enumerate(QUARTERS):
        d = dbg[64 * q:64 * (q + 1)]
        huff = name != "random"             # stored blocks skip 2 and 3
        t = d[:, :5] if huff else d[:, [0, 1, 1, 3, 4]]
        us = np.diff(np.concatenate([np.zeros((len(t), 1)), t], 1), 1) / 1e3
        row = {"quarter": name,
               "phase_us_mean": dict(zip(PHASES, us.mean(0).tolist())),
               "phase_us_max": dict(zip(PHASES, us.max(0).tolist()))}
        if huff:
            tot, cm, nl, nmat, ns = d[:, 5:10].mean(0)
            row.update({"cycles_per_ns": tot / ns, "literal_steps": nl,
                        "matches": nmat,
                        "cycles_per_literal_step": (tot - cm) / nl,
                        "cycles_per_match": cm / nmat})
        res["quarters"].append(row)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
