"""Port vs reference, the bare-stream entry points: ``decompress`` returns
the same bytes as deflate_tpu's, served by the same decoder (path
attribution and the device-to-host redirect), on this package's own
stream and on a foreign zlib stream; ``decompress_zlib`` verifies
Adler-32; ``decode_all`` of a hintless manifest goes through the block
inflate (K6's plain version here); and without a card the entry points
raise instead of running on the CPU."""
import zlib

import numpy as np
import pytest
import torch

import deflate_tpu
import deflate_tpu_torch as D
from deflate_tpu_torch.models import block_decoder as BD
from deflate_tpu_torch.models import host_inflate as HI
from deflate_tpu_torch.runtime import manifest as M
from torch_helpers import corpus, jax_native_lib


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    """The JAX package's native library, loaded before any test here
    compares against it."""
    jax_native_lib()


def _stream(kind: str):
    if kind == "own":
        data = corpus(2, seed=71)[:40000]
        stream, _ = M.compress_with_manifest(data, level=2, device="cpu")
        return data, stream
    data = b"zlib made this stream, not us. " * 3000
    return data, zlib.compress(data, 9)[2:-4]


@pytest.mark.parametrize("kind", ["own", "foreign"])
@pytest.mark.parametrize("force", [True, False], ids=["forced", "redirect"])
def test_decompress_matches_reference(kind, force):
    data, stream = _stream(kind)
    st, jst = {}, {}
    got = D.decompress(stream, len(data), device="cpu", force_device=force,
                       stats=st)
    want = deflate_tpu.decompress(stream, len(data), device=True,
                                  force_device=force, stats=jst)
    assert got == want == data
    assert st["device_path"] == jst["device_path"]
    assert st["redirected"] == jst["redirected"]
    assert st["device_path"] == ("wave" if force else "native_host")


def test_decompress_host_and_errors():
    data, stream = _stream("foreign")
    st = {}
    assert D.decompress(stream, device=None, stats=st) == data
    assert st["device_path"] == "native_host" and st["redirected"] is None
    with pytest.raises(D.InflateError):
        D.decompress(b"\x07\x00", device=None)
    with pytest.raises(D.InflateError):
        D.decompress(stream, len(data) - 1, device=None)


def test_decompress_falls_to_block_inflate_when_wave_declines(monkeypatch):
    """A stream the wave path declines goes to K6 (plain version here),
    recorded as "pallas_scalar"."""
    from deflate_tpu_torch.models import wave_decoder as WD

    data, stream = _stream("own")
    monkeypatch.setattr(WD, "skeleton_plan", lambda raw: None)
    st = {}
    assert D.decompress(stream, len(data), device="cpu", force_device=True,
                        stats=st) == data
    assert st["device_path"] == "pallas_scalar"


@pytest.mark.parametrize("device", ["cpu", None])
def test_decompress_zlib_verifies_adler32(device):
    data = corpus(1, seed=72)[:20000]
    z = zlib.compress(data, 6)
    assert D.decompress_zlib(z, device=device, force_device=True) == data
    assert HI.adler32(data) == zlib.adler32(data)
    bad = z[:-1] + bytes([z[-1] ^ 1])
    with pytest.raises(D.InflateError, match="adler32"):
        D.decompress_zlib(bad, device=device, force_device=True)


def test_hintless_decode_all_goes_through_block_inflate(monkeypatch):
    data = corpus(2, seed=73)[:50000]
    stream, man = M.compress_with_manifest(data, level=2, hints=False,
                                           device="cpu")
    assert man.hints is None
    served = []
    real = BD.inflate_manifest

    def spy(*a, **kw):
        out = real(*a, **kw)
        served.append(len(out))
        return out

    def no_host(*a, **kw):
        raise AssertionError("a block took the host decoder")

    monkeypatch.setattr(BD, "inflate_manifest", spy)
    monkeypatch.setattr(HI, "inflate_raw", no_host)
    assert M.decode_all(stream, man, device="cpu") == data
    assert served == [len(data)]


def test_block_decoder_flags_a_foreign_stream():
    """zlib's matches cross its blocks: K6 flags them and raises."""
    rng = np.random.default_rng(9)
    data = bytes(rng.integers(97, 100, 120000, dtype=np.uint8))
    raw = zlib.compress(data, 9)[2:-4]
    with pytest.raises(BD.PallasDecodeError):
        BD.inflate_stream(raw, device="cpu")


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card default works")
    data = b"no card, no silent CPU run " * 100
    stream, man = M.compress_with_manifest(data, level=2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.compress_with_manifest(data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.decode_all(stream, man)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.decompress(stream)
