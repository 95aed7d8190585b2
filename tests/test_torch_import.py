"""deflate_tpu_torch stands alone: it imports neither jax nor deflate_tpu,
and chip_smoke.py refuses to report without a card."""
import os
import shutil
import subprocess
import sys

from torch_helpers import ROOT

MODULES = ("deflate_tpu_torch", "deflate_tpu_torch._build",
           "deflate_tpu_torch.utils.bits", "deflate_tpu_torch.utils.tables",
           "deflate_tpu_torch.ops.huffman", "deflate_tpu_torch.ops.tree",
           "deflate_tpu_torch.ops.header", "deflate_tpu_torch.ops.lz77",
           "deflate_tpu_torch.ops.bitmerge", "deflate_tpu_torch.ops.wave",
           "deflate_tpu_torch.ops.wave_stagea",
           "deflate_tpu_torch.ops.wave_route",
           "deflate_tpu_torch.ops.wave_fill",
           "deflate_tpu_torch.models.encoder",
           "deflate_tpu_torch.models.wave_decoder",
           "deflate_tpu_torch.models.host_inflate",
           "deflate_tpu_torch.runtime.manifest",
           "deflate_tpu_torch.runtime.stitch")


def _run(code: str, cwd: str):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', "
            "'deflate_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = _run(code, ROOT)
    assert r.returncode == 0, (r.stdout, r.stderr)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """In this checkout and alone in a directory, chip_smoke.py exits
    non-zero and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    for cwd in (ROOT, str(tmp_path)):
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0, (cwd, r.stdout, r.stderr)
        assert '"ok"' not in r.stdout, (cwd, r.stdout)
