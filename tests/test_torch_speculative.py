"""Port vs reference, the speculative device decoder: the dynamic header
parse, the token scan and chain, the whole-stream decode, the standalone
block decode, and the three kinds of input that only this decoder
serves through ``decompress(force_device=True)``: a stored block longer
than 32 KiB and corrupt streams here, a wrong out_size (with
check_speculative_case) in test_torch_speculative_level1.py, _sizes.py,
_fixed.py and _mixed.py.

Both sides get the same numpy inputs; every stream's words are padded
with zeros to one length, so that each JAX function compiles once.
Integer outputs must agree exactly."""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deflate_tpu
import deflate_tpu_torch as D
from chip_smoke import SPECULATIVE_FLIPS, corrupt_streams, deflate_raw, \
    speculative_cases
from deflate_tpu.models import decoder as JD
from deflate_tpu.ops import header_decode as JHD
from deflate_tpu.ops import inflate_scan as JIS
from deflate_tpu_torch.models import decoder as TD
from deflate_tpu_torch.models import host_inflate as HI
from deflate_tpu_torch.ops import header_decode as HD
from deflate_tpu_torch.ops import inflate_scan as IS
from deflate_tpu_torch.runtime import manifest as M
from deflate_tpu_torch.utils import tables as T
from torch_helpers import assert_same, corpus, dynamic_header, jax_native_lib

WORDS = 32768                 # words every test stream is padded to
OUT_CAP = 1 << 18             # decode_stream's capacities, as in
MAX_BLOCKS = 8                # tests/test_decoder.py


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    """The JAX package's native library, loaded before any test here
    compares against its decompress."""
    jax_native_lib()


def _words(raw: bytes, nwords: int = WORDS) -> np.ndarray:
    w = np.zeros(nwords, np.uint32)
    n = -(-len(raw) // 4)
    assert n <= nwords, len(raw)
    w[:n] = np.frombuffer(raw + b"\0" * (4 * n - len(raw)), np.uint32)
    return w


def _both(w: np.ndarray):
    return jnp.asarray(w), torch.from_numpy(w.view(np.int32).copy())


HEADERS = {
    "zlib1": lambda: _stream("zlib1")[0],
    "zlib6": lambda: _stream("zlib6")[0],
    "zlib9": lambda: _stream("zlib9")[0],
    # 19 CL codes of length 1
    "oversubscribed_cl": lambda: dynamic_header(
        257, 1, {s: 1 for s in range(19)}, [(0, 0)] * 8),
    # 138 + 138 zero lengths where 258 are due
    "run_overflow": lambda: dynamic_header(
        257, 1, {1: 1, 18: 1}, [(18, 127), (18, 127)]),
    # literal 0 gets length 1, end-of-block (256) none
    "missing_eob": lambda: dynamic_header(
        257, 1, {1: 1, 18: 1}, [(1, 0), (18, 127), (18, 108)]),
    "hlit_287": lambda: dynamic_header(
        287, 1, {1: 1, 18: 1}, [(18, 127), (18, 127), (18, 1)]),
}


@pytest.mark.parametrize("name", list(HEADERS))
def test_parse_dynamic_header_matches_reference(name):
    raw = HEADERS[name]()
    assert (raw[0] >> 1) & 3 == 2, "the first block is not dynamic"
    jw, tw = _both(_words(raw[:8192], 2048))
    want = jax.jit(JHD.parse_dynamic_header)(jw, jnp.int32(3))
    got = HD.parse_dynamic_header(tw, 3)
    assert sorted(got) == sorted(want)
    for k in want:
        assert_same(got[k], want[k], k)
    assert bool(got["error"]) == (name not in ("zlib1", "zlib6", "zlib9"))


@pytest.mark.parametrize("strategy", [zlib.Z_DEFAULT_STRATEGY, zlib.Z_FIXED],
                         ids=["dynamic", "fixed"])
def test_token_scan_and_chain_match_reference(strategy):
    """One block: the LUTs, the token at every offset, the chain and the
    block's own output (emit_block_output)."""
    span, out_len = 1 << 15, 4096
    data = (b"speculative tokens at every offset; " * 60)[:2000] \
        + bytes(np.random.default_rng(3).integers(97, 105, 2000,
                                                  dtype=np.uint8))
    raw = deflate_raw(data, 6, strategy)
    jw, tw = _both(_words(raw, 2048))
    if strategy == zlib.Z_FIXED:
        lit = np.asarray(T.FIXED_LITLEN_LENGTHS, np.int32)
        dist = np.asarray(T.FIXED_DIST_LENGTHS[:30], np.int32)
        start = 3
    else:
        hdr = HD.parse_dynamic_header(tw, 3)
        lit, dist = hdr["litlen_lens"].numpy(), hdr["dist_lens"].numpy()
        start = int(hdr["body_start"])
    jl, jd = (jax.jit(JIS.build_lut)(jnp.asarray(x)) for x in (lit, dist))
    tl, td = (IS.build_lut(torch.from_numpy(x)) for x in (lit, dist))
    assert_same(tl, jl, "lit_lut")
    assert_same(td, jd, "dist_lut")
    jtok = jax.jit(JIS.token_scan, static_argnames=("span",))(
        jw, jl, jd, jnp.int32(start), span=span)
    tok = IS.token_scan(tw, tl, td, start, span=span)
    assert sorted(tok) == sorted(jtok)
    for k in jtok:
        assert_same(tok[k], jtok[k], k)
    want = jax.jit(JIS.find_chain, static_argnames=("span",))(jtok, span=span)
    got = IS.find_chain(tok, span=span)
    for g, w, k in zip(got, want, ("reached", "eob_local", "error")):
        assert_same(g, w, k)
    assert not bool(got[2]) and int(got[1]) < span
    jout = jax.jit(JIS.emit_block_output, static_argnames=("out_len",))(
        jtok, want[0], out_len=out_len)
    out = IS.emit_block_output(tok, got[0], out_len)
    assert_same(out[0], jout[0], "out")
    assert_same(out[1], jout[1], "produced")
    assert bytes(out[0].numpy()[:int(out[1])]) == data


def _stream(name: str):
    """The streams of tests/test_decoder.py: (raw, decoded bytes or None
    for the corrupt one)."""
    if name.startswith("zlib"):
        level = int(name[4:])
        rng = np.random.default_rng(level)
        data = bytes(rng.integers(97, 117, 30000, dtype=np.uint8))
        return deflate_raw(data, level), data
    if name == "corrupt":
        rng = np.random.default_rng(5)
        raw = bytearray(deflate_raw(
            bytes(rng.integers(97, 110, 20000, dtype=np.uint8)), 9))
        raw[5] ^= 0xFF
        return bytes(raw), None
    if name == "own_level2":
        pat = np.random.default_rng(3).integers(0, 200, 401, dtype=np.uint8)
        data = np.tile(pat, 300).tobytes()
        return M.compress_with_manifest(data, level=2, device="cpu")[0], data
    data = {"stored": b"\x00\x01\x02" * 5000,
            "cross_block": b"the quick brown fox jumps over the lazy dog. "
            * 3000,
            "long_run": b"a" * 100000,
            "incompressible": bytes(np.random.default_rng(4).integers(
                0, 256, 80000, dtype=np.uint8)),
            "empty": b""}[name]
    level = {"stored": 0, "incompressible": 9}.get(name, 6)
    return deflate_raw(data, level), data


@pytest.mark.parametrize("name", [
    "zlib1", "zlib6", "zlib9", "stored", "cross_block", "own_level2",
    "long_run", "incompressible", "empty", "corrupt"])
def test_decode_stream_matches_reference(name):
    raw, data = _stream(name)
    jw, tw = _both(_words(raw))
    nbits = 8 * len(raw)
    jo, jt, jn, je = JD.decode_stream(jw, np.int32(nbits), JIS.SPAN,
                                      OUT_CAP, MAX_BLOCKS)
    to, tt, tn, te = TD.decode_stream(tw, nbits, IS.SPAN, OUT_CAP,
                                      MAX_BLOCKS)
    assert (int(tt), int(tn), bool(te)) == (int(jt), int(jn), bool(je))
    assert_same(to[:int(tt)], np.asarray(jo)[:int(jt)], "out")
    if data is None:
        assert bool(te) or bytes(to[:int(tt)].numpy()) != data
    else:
        assert not bool(te) and bytes(to[:int(tt)].numpy()) == data


@pytest.fixture(scope="module")
def manifest4():
    """A 4-block level-2 stream (text, repeats, words, stored random)."""
    stream, man = M.compress_with_manifest(corpus(4, seed=31), level=2,
                                           device="cpu")
    return stream, man


@pytest.mark.parametrize("block", range(4))
def test_decode_block_standalone_matches_reference(manifest4, block):
    stream, man = manifest4
    start, _, size = man.blocks[block]
    jw, tw = _both(_words(stream))
    want = jax.jit(JD.decode_block_standalone,
                   static_argnames=("span", "out_cap"))(
        jw, jnp.int32(start), span=JIS.SPAN, out_cap=T.BLOCK_SIZE)
    got = TD.decode_block_standalone(tw, start, IS.SPAN, T.BLOCK_SIZE)
    for g, w, k in zip(got, want, ("out", "produced", "error")):
        assert_same(g, w, k)
    assert int(got[1]) == size and not bool(got[2])


def test_corrupt_cases_are_named_by_their_flips():
    """SPECULATIVE_FLIPS are streams of the thirty corrupt ones."""
    flips = [f for f, _ in corrupt_streams()]
    assert len(flips) == 30 and set(SPECULATIVE_FLIPS) <= set(flips)


CASES = {name: (raw, size, data)
         for name, raw, size, data in speculative_cases()}
# both packages first run their wavefront decode on a wrong-size stream
# (30-110 s a stream here), so those run in other files:
# tests/test_torch_speculative_level1.py, _sizes.py, _fixed.py, _mixed.py
ELSEWHERE = ("level1", "level9", "filtered", "fixed", "mixed")


def check_speculative_case(name: str, monkeypatch) -> None:
    """CASES[name] decodes through "speculative" in both packages, to
    the same bytes or to InflateError; only a corrupt stream reaches the
    host decoder, after both capacity configurations flagged it."""
    raw, size, data = CASES[name]
    host_calls, flags = [], []
    real_host, real_stream = HI.inflate_raw, TD.decode_stream

    def host(*a, **kw):
        host_calls.append(a)
        return real_host(*a, **kw)

    def stream(*a, **kw):
        res = real_stream(*a, **kw)
        flags.append(bool(res[3]))
        return res

    monkeypatch.setattr(HI, "inflate_raw", host)
    monkeypatch.setattr(TD, "decode_stream", stream)
    st, jst = {}, {}
    try:
        got = D.decompress(raw, size, device="cpu", force_device=True,
                           stats=st)
    except D.InflateError:
        got = D.InflateError
    try:
        want = deflate_tpu.decompress(raw, size, device=True,
                                      force_device=True, stats=jst)
    except deflate_tpu.InflateError:
        want = D.InflateError
    assert got == want
    if data is None:
        assert got is D.InflateError
        assert flags == [True, True] and len(host_calls) == 1
    else:
        assert got == data and not host_calls
        assert st["device_path"] == jst["device_path"] == "speculative"
        assert flags[-1] is False
    if name == "stored_50000":   # past 32 KiB: only the second config
        assert flags == [True, False]


@pytest.mark.parametrize("name", [n for n in CASES
                                  if not n.startswith(ELSEWHERE)])
def test_speculative_cases_match_reference(name, monkeypatch):
    check_speculative_case(name, monkeypatch)


def test_inflate_device_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card default works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.inflate_device(deflate_raw(b"no card", 6))
