"""Port vs reference, the options of ``compress`` and ``decompress``:
``stats`` (the same report but for the times and the backend's name,
"device" where the reference says "tpu"), ``backend="native"`` and
``"auto"``, both ``config`` branches (the zlib container, and
emit_manifest with the manifest in stats), ``decompress(config=...)``,
``CodecConfig``'s validation, and the entry points' errors, including
their refusal to run without a card."""
import zlib

import numpy as np
import pytest
import torch

import deflate_tpu
import deflate_tpu_torch as D
from deflate_tpu.utils.config import CodecConfig as JConfig
from torch_helpers import jax_native_lib

# two blocks: the reference's 8-block batch, compiled once for the file
DATA = b"statistics " * 3000 + bytes(range(256)) * 16


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    jax_native_lib()


def test_stats_match_reference():
    got_st, want_st = {}, {}
    got = D.compress(DATA, 2, stats=got_st, device="cpu")
    assert got == deflate_tpu.compress(DATA, 2, stats=want_st)
    assert got_st.pop("backend") == "device"
    assert want_st.pop("backend") == "tpu"
    for st in (got_st, want_st):
        assert st.pop("seconds") >= 0 and st.pop("mb_per_s") >= 0
    assert got_st == want_st
    assert got_st["block_types"] == {"stored": 0, "fixed": 1, "dynamic": 1}
    assert got_st["bytes_out"] == len(got)


@pytest.mark.parametrize("backend", ["native", "auto"])
@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_native_and_auto_backends_match_reference(backend, level):
    small = DATA[:10000]
    st_got, st_want = {}, {}
    got = D.compress(small, level, backend, stats=st_got, device="cpu")
    assert got == deflate_tpu.compress(small, level, backend,
                                       stats=st_want)
    assert zlib.decompress(got, -15) == small
    for st in (st_got, st_want):
        del st["seconds"], st["mb_per_s"]
    assert st_got == st_want and st_got["backend"] == "native"


def test_auto_backend_takes_the_device_from_one_block():
    got = D.compress(DATA, 2, "auto", device="cpu")
    assert got == D.compress(DATA, 2, device="cpu") \
        == deflate_tpu.compress(DATA, 2, "auto")


@pytest.mark.parametrize("container", ["raw", "zlib"])
def test_config_compress_matches_reference(container):
    got = D.compress(DATA, config=D.CodecConfig(level=2,
                                                container=container),
                     device="cpu")
    want = deflate_tpu.compress(DATA, config=JConfig(level=2,
                                                     container=container))
    assert got == want
    back = zlib.decompress(got) if container == "zlib" \
        else zlib.decompress(got, -15)
    assert back == DATA


@pytest.mark.parametrize("container", ["raw", "zlib"])
def test_config_emit_manifest_matches_reference(container):
    st_got, st_want = {}, {}
    got = D.compress(DATA, config=D.CodecConfig(
        level=2, container=container, emit_manifest=True), stats=st_got,
        device="cpu")
    want = deflate_tpu.compress(DATA, config=JConfig(
        level=2, container=container, emit_manifest=True), stats=st_want)
    assert got == want
    man_got, man_want = st_got.pop("manifest"), st_want.pop("manifest")
    assert man_got.to_bytes() == man_want.to_bytes()
    assert st_got == st_want
    with pytest.raises(ValueError, match="needs a stats dict"):
        D.compress(DATA, config=D.CodecConfig(emit_manifest=True),
                   device="cpu")


@pytest.mark.parametrize("device_decode", [False, True])
@pytest.mark.parametrize("container", ["raw", "zlib"])
def test_config_decompress_matches_reference(container, device_decode):
    enc = zlib.compress(DATA, 6)
    if container == "raw":
        enc = enc[2:-4]
    cfg = dict(container=container, device_decode=device_decode)
    st_got, st_want = {}, {}
    got = D.decompress(enc, device="cpu", config=D.CodecConfig(**cfg),
                       stats=st_got)
    assert got == deflate_tpu.decompress(enc, config=JConfig(**cfg),
                                         stats=st_want) == DATA
    if container == "zlib":
        assert st_got == st_want
    else:
        assert st_got["device_path"] == st_want["device_path"] \
            == "native_host"
        assert st_got["device"] == ("cpu" if device_decode else None)


BAD_CONFIGS = [dict(level=7), dict(level=-1), dict(container="gzip"),
               dict(backend="gpu"), dict(block_size=0),
               dict(block_size=32769)]


@pytest.mark.parametrize("kw", BAD_CONFIGS,
                         ids=[next(iter(k)) + "=" + str(next(iter(k.values())))
                              for k in BAD_CONFIGS])
def test_codec_config_errors_match_reference(kw):
    with pytest.raises(ValueError) as ours:
        D.CodecConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        JConfig(**kw)
    assert str(ours.value) == str(theirs.value)


def test_codec_config_backend_names():
    """The port's "device" is the reference's "tpu"; each package
    refuses the other's name with the same message form."""
    assert D.CodecConfig().backend == "device"
    assert JConfig().backend == "tpu"
    with pytest.raises(ValueError, match="unknown backend 'tpu'"):
        D.CodecConfig(backend="tpu")
    with pytest.raises(ValueError, match="unknown backend 'device'"):
        JConfig(backend="device")
    with pytest.raises(ValueError, match="unknown backend 'tpu'"):
        D.compress(b"x", backend="tpu", device="cpu")
    with pytest.raises(ValueError, match="level must be 0..3"):
        D.compress(b"x", 4, device="cpu")
    with pytest.raises(ValueError, match="level must be 0..3"):
        deflate_tpu.compress(b"x", 4)


def test_public_api_matches_reference():
    assert D.__all__ == deflate_tpu.__all__
    for name in D.__all__:
        assert hasattr(D, name), name


def test_compress_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card default works")
    src = tmp_path / "in.bin"
    src.write_bytes(b"no card")
    for fn in (lambda: D.compress(b"x"),
               lambda: D.compress(b"x", backend="native"),
               lambda: D.compress_zlib(b"x"), lambda: D.compress_gzip(b"x"),
               lambda: D.compress_many([b"x"]),
               lambda: D.compress_file(str(src), str(tmp_path / "o")),
               lambda: D.decompress_many([b"\x03\x00"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert np.array_equal(np.frombuffer(src.read_bytes(), np.uint8),
                          np.frombuffer(b"no card", np.uint8))


def test_run_report_matches_reference():
    from deflate_tpu.utils.metrics import RunReport as JReport
    from deflate_tpu_torch.utils.metrics import RunReport

    reports = []
    for cls in (RunReport, JReport):
        r = cls("encode")
        r.bytes_in, r.bytes_out = 1000, 300
        r.add_blocks([0, 2, 2, 1])
        r.extra["level"] = 2
        d = r.finish()
        del d["seconds"], d["mb_per_s"]
        reports.append(d)
    assert reports[0] == reports[1]
    assert reports[0]["ratio"] == 0.3


def test_trace_and_profile_to(tmp_path):
    """profile_to writes a Chrome trace holding trace's named ranges."""
    import json

    from deflate_tpu_torch.utils.metrics import profile_to, trace

    with profile_to(str(tmp_path)):
        with trace("dt_region"):
            torch.arange(1000).sum()
        with trace("dt_off", enabled=False):
            torch.arange(10).sum()
    events = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "dt_region" in names and "dt_off" not in names
