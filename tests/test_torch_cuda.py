"""CUDA kernels of deflate_tpu_torch against their plain versions, and
the main path on the card against the CPU.  Every test skips without an
NVIDIA GPU.  This file imports no JAX, so it also runs where JAX is
absent:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:randomly -o addopts=""
"""
import numpy as np
import pytest
import torch

from deflate_tpu_torch.ops import huffman as H
from deflate_tpu_torch.ops import tree
from deflate_tpu_torch.ops import wave as W
from deflate_tpu_torch.ops import wave_fill as WF
from deflate_tpu_torch.ops import wave_route as WR
from deflate_tpu_torch.ops import wave_stagea as WS
from deflate_tpu_torch.runtime import manifest as M
from torch_helpers import (assert_same, corpus, cuda_device,  # noqa: F401
                           fill_case, monotone_instance)

pytestmark = pytest.mark.cuda


def test_k1_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(1)
    for n in (288, 30, 19):
        f = rng.integers(0, 300, (768, n)).astype(np.int32)
        f[rng.random(f.shape) < 0.3] = 0
        f[:3] = 0
        f[1, 5] = 9
        f[2, [0, n - 1]] = 4
        lw, _, nz = H._sort_leaves(torch.from_numpy(f).to(cuda_device))
        got = tree.depths_kernel(lw, nz)
        want = tree.depths_plain(lw, nz)
        torch.cuda.synchronize()
        assert_same(got, want, f"K1 n={n}")


def test_k2_kernel_matches_plain(cuda_device):
    data = corpus(4, seed=21)
    stream, man = M.compress_with_manifest(data, level=2)
    offs = [b[0] for b in man.blocks]
    md = W.parse_headers_host(stream, offs)
    huff = [i for i in range(len(offs)) if md["btype"][i] != 0]
    W64 = 4224
    nw = W.prepare_windows(stream, md["data_start"][huff], W64)
    hints = man.hint_array()[huff]
    hs = np.full((len(huff), W64), W.HINT_NONE, np.int32)
    hs[:, :hints.shape[1]] = hints
    mds = torch.stack([torch.from_numpy(np.asarray(md[k])[huff])
                       for k in W.MD_KEYS], 1).to(cuda_device)
    nwt = torch.from_numpy(nw).to(cuda_device)
    hst = torch.from_numpy(hs).to(cuda_device)
    stop = torch.full((len(huff),), 1000, dtype=torch.int32,
                      device=cuda_device)
    for st, ml, mdx in ((None, 15, 15), (stop, 15, 15), (None, 12, 13)):
        got = WS.decode_mark_kernel(nwt, hst, mds, W64, st, ml, mdx)
        want = WS.decode_mark_plain(nwt, hst, mds, W64, st, ml, mdx)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ("A0c", "P1c", "sums")):
            assert_same(g, w, name)


def test_k3_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(7)
    for left in (True, False):
        pays, delta = monotone_instance(rng, 4, 33792, left)
        args = ([torch.from_numpy(p).to(cuda_device) for p in pays],
                torch.from_numpy(delta).to(cuda_device), 16, left)
        (ga, gb), gd = WR.route_kernel(*args)
        (wa, wb), wd = WR.route_plain(*args)
        torch.cuda.synchronize()
        assert_same(gd, wd, "dout")
        assert_same(ga, wa, "payload 0")
        assert_same(gb, wb, "payload 1")


def test_k4_kernel_matches_plain(cuda_device):
    lit, rec0, rec1, nmatch = fill_case(8)
    recs = WF.pack_fill_recs(torch.from_numpy(rec0), torch.from_numpy(rec1))
    args = [x.to(cuda_device) for x in
            (torch.from_numpy(lit), recs, torch.from_numpy(nmatch))]
    got = WF.fill_matches_kernel(*args)
    want = WF.fill_matches_plain(*args)
    torch.cuda.synchronize()
    assert_same(got, want, "K4")


def test_main_path_on_card_equals_cpu(cuda_device):
    data = corpus(4, seed=33)[:4 * 32768 - 77]
    s_cpu, m_cpu = M.compress_with_manifest(data, level=2)
    s_gpu, m_gpu = M.compress_with_manifest(data, level=2,
                                            device=cuda_device)
    assert s_gpu == s_cpu
    assert m_gpu.to_bytes() == m_cpu.to_bytes()
    assert M.decode_all(s_gpu, m_gpu, device=cuda_device) == data
