"""The port's native library under ASan and UBSan: the fuzz driver
(deflate_tpu_torch/native/asan_fuzz.cpp) feeds random garbage,
truncations and one-byte corruptions of valid streams to dt_inflate,
dt_inflate2, dt_parse_headers (at offsets anywhere, extreme ones
included), dt_skeleton and dt_skeleton_par (in pieces of 16 to 1024
bytes on 2-4 threads, held to dt_skeleton's code and plan); any
sanitizer finding or a differing plan fails it."""
import subprocess

from deflate_tpu_torch import native


def test_asan_ubsan_fuzz_driver_builds_and_passes():
    exe = native.build_asan_fuzz()
    r = subprocess.run([exe], capture_output=True, timeout=120, text=True)
    assert r.returncode == 0, f"sanitizer findings:\n{r.stderr[-3000:]}"
    assert "asan_fuzz ok=" in r.stdout


def test_parse_headers_flags_offsets_out_of_range():
    """Offsets past the end, negative and at the int64 extremes come back
    flagged (the fuzz driver's extreme offsets, through the binding)."""
    import numpy as np

    data = bytes(range(200))
    offs = [0, 8 * len(data), -1, 2**63 - 1, -2**63, 2**63 - 3]
    hd = native.parse_headers(data, np.array(offs, np.int64))
    assert hd["err"][1:].all()
