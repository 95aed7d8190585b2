"""Port vs reference, the driver entry points (deflate_tpu_torch/entry.py
against __graft_entry__.py): entry()'s encode step on its example blocks
gives the reference's stream, and dryrun_multichip runs its checks on a
world of one (in this process, with the working directory in tmp_path:
it must write no file) and of two gloo ranks."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from deflate_tpu.ops.bitpack import words_to_bytes as jax_words_to_bytes
from deflate_tpu_torch import entry as EN
from deflate_tpu_torch.ops.bitpack import words_to_bytes
from torch_helpers import run_ranks


def test_entry_matches_reference():
    import __graft_entry__ as GE

    jfn, jargs = GE.entry()
    jw, jt = jfn(*jargs)
    fn, args = EN.entry(device="cpu")
    for a, j in zip(args[:3], jargs[:3]):
        assert np.array_equal(a.numpy(), np.asarray(j))
    w, total = fn(*args)
    assert int(total) == int(jt)
    assert words_to_bytes(w, total) == jax_words_to_bytes(np.asarray(jw),
                                                          int(jt))


def test_entry_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EN.entry()


def _check_record(rec, n):
    assert rec["n_devices"] == n and rec["blocks"] == 4 * n
    assert rec["card"] == "cpu"
    assert rec["t_single_s"] > 0 and rec["t_mesh_s"] > 0
    assert rec["passed"] == (rec["mesh_speedup_vs_single_program"] >= 0.8)


def test_dryrun_world_of_one_writes_no_file(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    try:
        rec = EN.dryrun_multichip(1, device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    _check_record(rec, 1)
    assert "SCALING" in capsys.readouterr().out
    assert list(tmp_path.iterdir()) == []


def test_dryrun_two_ranks(tmp_path):
    recs = run_ranks(tmp_path, 2, "dryrun", 2)
    for rec in recs:
        _check_record(rec, 2)
    assert not (tmp_path / "SCALING.json").exists()


def test_dryrun_refuses_a_wrong_world(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    try:
        with pytest.raises(ValueError, match="need 2 ranks"):
            EN.dryrun_multichip(2, device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
