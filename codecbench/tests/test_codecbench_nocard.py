"""Without a card the benchmark fails and prints no result; on a card it
runs one cell end to end (marked cuda, skipped here)."""
import json
import os
import subprocess
import sys

import pytest

from helpers import ROOT


def _run(*args, cwd=ROOT, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "codecbench.run", *args], cwd=cwd,
        capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, PYTHONPATH=""))


def test_no_card_no_run():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    r = _run("--workload", "archive-l2.write", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert r.returncode != 0
    assert "{" not in r.stdout
    assert "CUDA" in r.stderr


def test_unknown_workload_fails():
    r = _run("--workload", "no-such.cell", "--seed", "1", "--seconds", "1")
    assert r.returncode != 0 and r.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_one_cell_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = _run("--workload", "bare-deflate.read", "--seed", "5",
             "--seconds", "2", "--trace", str(trace), timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
