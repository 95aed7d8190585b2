"""The plain level-3 reference (tests/plain_level3.py, the benchmark's
codecbench/reference/level3.py) on seeded access-log bytes: its tokens
rebuild each block, it equals a per-position loop of the same definition,
and it holds the port's level-3 streams within the benchmark's
ratio_ceiling while the port's level-2 streams exceed it.  No JAX."""
import json
import os

import numpy as np
import pytest
import torch

import plain_level3 as R
from deflate_tpu_torch.runtime import manifest as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = json.load(open(os.path.join(ROOT, "codecbench", "configs",
                                     "logs-l3.json")))
N = R.N


def zipf_draw(rng, n, size, s=0.8):
    p = np.arange(1, n + 1, dtype=np.float64) ** -s
    return rng.choice(n, size, p=p / p.sum())


def log_lines(seed: int, nbytes: int) -> bytes:
    """Combined Log Format lines, cut at nbytes: the benchmark generator's
    line maker (codecbench/data/access_logs.py) with smaller
    vocabularies, Zipf 0.8 popularity, timestamps in steps of 0-2 s."""
    rng = np.random.default_rng(seed)
    ips = [b"%d.%d.%d.%d" % tuple(o)
           for o in rng.integers(1, 255, (512, 4)).tolist()]
    words = b"api static img products items users cart search blog".split()
    paths = [b"/" + b"/".join(words[k] for k in rng.integers(0, len(words),
                                                            rng.integers(1, 5)))
             + (b"/%d" % rng.integers(1, 10 ** 6) if rng.random() < .3
                else b"") for _ in range(256)]
    agents = [b"Mozilla/5.0 (Windows NT 10.0; Win64; x64) AppleWebKit/537.36 "
              b"(KHTML, like Gecko) Chrome/%d.0.%d.%d Safari/537.36"
              % tuple(rng.integers(100, 6000, 3)) for _ in range(32)]
    refs = [b"-"] + [b"https://www.example.com" + p for p in paths[:64]]
    out, t, size = [], 1_700_000_000, 0
    while size < nbytes:
        t += int(rng.integers(0, 3))
        stamp = np.datetime64(t, "s").astype(object)
        line = b'%s - - [%s +0000] "%s %s HTTP/1.1" %s %d "%s" "%s"\n' % (
            ips[zipf_draw(rng, 512, 1)[0]],
            stamp.strftime("%d/%b/%Y:%H:%M:%S").encode(),
            b"GET" if rng.random() < .9 else b"POST",
            paths[zipf_draw(rng, 256, 1)[0]],
            rng.choice([b"200", b"304", b"404"], p=[.85, .1, .05]),
            rng.integers(0, 60000), refs[zipf_draw(rng, 65, 1)[0]],
            agents[zipf_draw(rng, 32, 1)[0]])
        out.append(line)
        size += len(line)
    return b"".join(out)[:nbytes]


def blocks_of(data: bytes):
    n = -(-len(data) // N)
    buf = np.zeros(n * N, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    blen = np.clip(len(data) - N * np.arange(n), 0, N)
    return torch.from_numpy(buf.reshape(n, N)), torch.from_numpy(blen)


@pytest.fixture(scope="module")
def logs():
    """4 blocks (128 KiB) of log lines."""
    return log_lines(2 ** 31 + 5, 4 * N)


@pytest.fixture(scope="module")
def ref_bits(logs):
    return R.block_bits(*blocks_of(logs))


def replay(data: bytes, start, taken, dist) -> bytes:
    out = bytearray()
    for p in torch.nonzero(start).flatten().tolist():
        if taken[p]:
            for _ in range(int(taken[p])):
                out.append(out[-int(dist[p])])
        else:
            out.append(data[p])
    return bytes(out)


@pytest.mark.parametrize("cut", [0, 5000])
def test_reference_tokens_rebuild_each_block(logs, cut):
    data = logs[:len(logs) - cut]
    block, blen = blocks_of(data)
    start, taken, dist = R.tokens(block, blen)
    for b in range(len(blen)):
        part = data[b * N:(b + 1) * N]
        assert replay(part, start[b], taken[b], dist[b]) == part, b
        assert not start[b, int(blen[b]):].any()
    assert (taken[start] > 0).float().mean() > 0.1      # matches were used


def loop_tokens(data: bytes):
    """The reference's definition position by position, in Python."""
    n = len(data)
    cnt = np.bincount(np.frombuffer(data, np.uint8), minlength=256) / n
    ent = -sum(p * np.log2(p) for p in cnt if p > 0)
    far = R.FAR_LOW if ent < R.ENTROPY_CUT else R.FAR_HIGH
    best = [(0, 0)] * n
    for j in range(n):
        bl, bd = 0, 0
        for g in R.GRAMS:
            if j + g > n:
                continue
            found = 0
            for i in range(j - 1, -1, -1):
                if found == R.DEPTH:
                    break
                if data[i:i + g] != data[j:j + g]:
                    continue
                found += 1
                L = 0
                cap = min(R.MAX_MATCH, n - j)
                while L < cap and data[i + L] == data[j + L]:
                    L += 1
                if L == R.MIN_MATCH and j - i > far:
                    continue
                if L > bl or (L == bl and L and j - i < bd):
                    bl, bd = L, j - i
        best[j] = (bl, bd)
    tokens, p = [], 0
    while p < n:
        room = min(R.TILE - p % R.TILE, n - p)
        ml = min(best[p][0], room)
        nx = min(best[p + 1][0], room - 1) if p + 1 < n else 0
        if ml >= R.MIN_MATCH and not nx > ml:
            tokens.append((p, ml, best[p][1]))
            p += ml
        else:
            tokens.append((p, 0, 0))
            p += 1
    return tokens


@pytest.mark.parametrize("kind", ["logs", "low_entropy"])
def test_reference_equals_a_per_position_loop_on_2k(logs, kind):
    if kind == "logs":
        data = logs[:2048]
    else:                     # 3 bits of entropy: the far cut is FAR_LOW
        rng = np.random.default_rng(3)
        data = bytes(rng.choice(list(b"abcdefgh"), 2048).astype(np.uint8))
    block, blen = blocks_of(data)
    start, taken, dist = R.tokens(block, blen)
    got = [(p, int(taken[0, p]), int(dist[0, p]))
           for p in torch.nonzero(start[0]).flatten().tolist()]
    assert got == loop_tokens(data)


def _port_bits(data: bytes, level: int) -> np.ndarray:
    _, man = M.compress_with_manifest(data, level=level, device="cpu")
    return np.array([b[1] for b in man.blocks], np.float64)


def test_port_level3_is_within_the_ceiling_on_every_block(logs, ref_bits):
    ratio = _port_bits(logs, 3) / ref_bits.numpy()
    assert (ratio <= CONFIG["ratio_ceiling"]).all(), ratio
    assert (ratio >= 1).all(), ratio       # the reference is the smaller


def test_port_level2_is_over_the_ceiling_on_every_block(logs, ref_bits):
    ratio = _port_bits(logs, 2) / ref_bits.numpy()
    assert (ratio > CONFIG["ratio_ceiling"]).all(), ratio


def test_the_benchmark_s_copy_gives_the_same_sizes(logs, ref_bits):
    from codecbench.reference import level3

    assert torch.equal(level3.block_bits(*blocks_of(logs)), ref_bits)
    src = open(os.path.join(ROOT, "codecbench", "reference", "level3.py"))
    assert src.read() == open(R.__file__).read()
