"""Nothing the benchmark runs loads JAX or the JAX package."""
import json
import os
import subprocess
import sys

from helpers import CELLS, ROOT, TINY

REHEARSAL = """
import json, sys
from codecbench import harness
from codecbench.run import forbidden_modules
for name in {cells!r}:
    run = harness.Run(harness.load_cell(name), 7, "cpu", **{tiny!r})
    ops = run.loop(0)
    assert harness.verdict(run.judge(ops), ops), name
    run.close()
print(json.dumps(forbidden_modules()))
"""


def test_cpu_rehearsal_of_every_cell_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-c", REHEARSAL.format(cells=CELLS, tiny=TINY)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from codecbench.run import forbidden_modules

    monkeypatch.setitem(sys.modules, "deflate_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxlib_lookalike.x", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "deflate_tpu.ops", sys)
    assert forbidden_modules() == ["deflate_tpu"]


def test_a_forbidden_module_loaded_at_the_end_stops_the_result(
        monkeypatch, capsys):
    from codecbench.run import emit

    result = {"correct": True, "checks": {"ops_wrong": {"value": 0,
                                                        "limit": 0}}}
    assert emit({}, result) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith("{")
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert emit({}, result) != 0
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err
