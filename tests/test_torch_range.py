"""The range read on a device, ``runtime/manifest.decode_range(...,
device=)``, on the CPU with the plain kernel versions: ~300 KB of access
logs (codecbench/data/access_logs.py) written at level 3 with entry
phases (the wavefront branch) and at level 2 without (K6's branch).  On
every range it equals the host read (device=None), the chunk's bytes,
the benchmark's plain range reference (codecbench/reference/range.py)
and the JAX package's ``decode_range``; it decodes the range's blocks
alone, from the stream's bytes that hold them, and counts them.  The
bisected ``Manifest.blocks_for_range`` equals the linear scan it
replaces, and ``decode_all`` still decodes the same manifests."""
import inspect

import numpy as np
import pytest

import deflate_tpu_torch as D
from codecbench.data import access_logs
from codecbench.reference import range as reference
from deflate_tpu.runtime import manifest as JM
from deflate_tpu_torch.runtime import manifest as M
from deflate_tpu_torch.utils import metrics
from torch_helpers import corrupt_block3

SEED = 2 ** 31 + 26
SIZE = 300_000


@pytest.fixture(scope="module")
def chunk():
    return access_logs.make_pool(SEED, 1, SIZE)[0]


@pytest.fixture(scope="module")
def archives(chunk):
    """{"hinted": level 3 with entry phases, "hintless": level 2 without},
    each (stream, manifest)."""
    return {"hinted": M.compress_with_manifest(chunk, level=3,
                                               device="cpu"),
            "hintless": M.compress_with_manifest(chunk, level=2, hints=False,
                                                 device="cpu")}


def _bounds(name, man):
    """(start, end) of the named range, from the manifest's block edges."""
    s = man.out_starts()
    return {"empty": (1000, 1000),
            "inside_one_block": (100, 5000),
            "across_a_block_edge": (s[1] - 300, s[1] + 300),
            "first_block": (0, s[1]),
            "last_block": (s[-2], s[-1]),
            "several_blocks": (s[1] + 7, s[4] - 7),
            "whole_stream": (0, s[-1]),
            "past_the_end": (s[-1] - 50, s[-1] + 1000),
            "wholly_past_the_end": (s[-1] + 10, s[-1] + 20)}[name]


RANGES = ["empty", "inside_one_block", "across_a_block_edge", "first_block",
          "last_block", "several_blocks", "whole_stream", "past_the_end",
          "wholly_past_the_end"]


@pytest.mark.parametrize("kind", ["hinted", "hintless"])
@pytest.mark.parametrize("name", RANGES)
def test_device_range_read_matches_host_chunk_reference_and_jax(
        chunk, archives, kind, name):
    stream, man = archives[kind]
    assert (man.hints is not None) == (kind == "hinted")
    start, end = _bounds(name, man)
    metrics.reset()
    with metrics.recording(sync=False):
        got = M.decode_range(stream, man, start, end, device="cpu")
    snap = metrics.snapshot()
    jman = JM.Manifest.from_bytes(man.to_bytes())
    assert got == chunk[start:end]
    assert got == M.decode_range(stream, man, start, end, device=None)
    assert got == reference.decode_range(stream, man.blocks, start, end)
    assert got == JM.decode_range(stream, jman, start, end)

    assert snap["ops"] == 1 and snap["spans"]["decode"]["n"] == 1
    stop = min(end, len(chunk))
    if start >= stop:
        assert snap["counts"] == {}
        return
    idxs = man.blocks_for_range(start, stop)
    path = "wave" if kind == "hinted" else "pallas_scalar"
    assert snap["counts"] == {
        "decode.range_blocks": len(idxs),
        "decode.range_bytes_decoded": sum(man.blocks[i][2] for i in idxs),
        "decode.range_bytes_returned": stop - start,
        f"decode.path.{path}": 1}
    assert "decode.range_plan" in snap["spans"]


@pytest.mark.parametrize("kind", ["hinted", "hintless"])
def test_device_range_read_reads_only_its_blocks_bytes(chunk, archives,
                                                      kind):
    """Every stream byte outside the range's blocks' span overwritten:
    the device read and the host read are unchanged."""
    stream, man = archives[kind]
    s = man.out_starts()
    start, end = s[2] + 11, s[5] - 13
    first = man.blocks[2][0] // 8
    off, bl, _ = man.blocks[4]
    last = -(-(off + bl) // 8)
    junk = bytes(range(256)) * (len(stream) // 256 + 1)
    smeared = junk[:first] + stream[first:last] + junk[last:len(stream)]
    for device in ("cpu", None):
        assert M.decode_range(smeared, man, start, end,
                              device=device) == chunk[start:end]


@pytest.mark.parametrize("kind", ["hinted", "hintless"])
def test_decode_all_is_unchanged_on_the_same_manifests(chunk, archives,
                                                       kind):
    stream, man = archives[kind]
    metrics.reset()
    with metrics.recording(sync=False):
        assert M.decode_all(stream, man, device="cpu") == chunk
    counts = metrics.snapshot()["counts"]
    assert M.decode_all(stream, man, device=None) == chunk
    assert "decode.blocks_fallback" not in counts
    assert counts == {"decode.path.wave" if kind == "hinted"
                      else "decode.path.pallas_scalar": 1}


def test_a_flagged_block_of_a_range_goes_to_the_host(archives):
    stream, man = archives["hinted"]
    bad = corrupt_block3(stream, man)
    s = man.out_starts()
    metrics.reset()
    with metrics.recording(sync=False):
        try:
            M.decode_range(bad, man, s[2], s[5], device="cpu")
        except (D.InflateError, ValueError, IndexError):
            pass
    snap = metrics.snapshot()
    assert snap["counts"]["decode.blocks_fallback"] >= 1
    assert "decode.fallback" in snap["spans"]


def test_a_negative_start_is_refused_on_a_device(archives):
    stream, man = archives["hinted"]
    for device in ("cpu", None):
        with pytest.raises(ValueError):
            M.decode_range(stream, man, -1, 100, device=device)


def test_the_range_read_defaults_to_the_card():
    device = inspect.signature(M.decode_range).parameters["device"]
    assert device.default == "cuda"


def _linear(blocks, start, end):
    """The linear scan that blocks_for_range replaced."""
    out, pos = [], 0
    for i, (_, _, olen) in enumerate(blocks):
        if pos < end and pos + olen > start:
            out.append(i)
        pos += olen
        if pos >= end:
            break
    return out


def test_bisected_blocks_for_range_equals_the_linear_scan(archives):
    rng = np.random.default_rng(5)
    sizes = [32768, 0, 100, 0, 0, 32768, 5, 0]      # empty blocks too
    mans = [archives["hinted"][1],
            M.Manifest(32768, 0, [(0, 8, n) for n in sizes])]
    for man in mans:
        total = man.out_size
        points = sorted({0, total, *man.out_starts(),
                         *rng.integers(-5, total + 5, 40).tolist()})
        for a in points:
            for b in points:
                assert man.blocks_for_range(a, b) == _linear(man.blocks, a,
                                                             b), (a, b)
    man = mans[1]
    man.blocks = man.blocks[:3]                     # a new table
    assert man.out_starts() == [0, 32768, 32768, 32868]
    man.blocks[1] = (8, 8, 7)                       # a block edited in place
    assert man.out_starts() == [0, 32768, 32775, 32875]
    assert man.blocks_for_range(32770, 32771) == [1]


def test_hint_rows_of_some_blocks(archives):
    man = archives["hinted"][1]
    whole = man.hint_array()
    some = man.hint_array([5, 2, 3])
    cap = max(len(man.hints[i]) for i in (5, 2, 3))
    assert some.shape == (3, cap)
    assert (some == whole[[5, 2, 3], :cap]).all()
    assert archives["hintless"][1].hint_array([0]) is None
