"""ctypes bindings of the native host library (native/inflate.cpp and
native/deflate.cpp).

Both sources are copies of deflate_tpu/native/'s.  At first use they are
compiled together, as that package's Makefile does, with ``g++ -O2
-shared -fPIC`` into one library in the gitignored
``deflate_tpu_torch/_build/``, named by a hash of both sources and the
flags so an edited source rebuilds.  A failed build raises: there is no
pure-Python stand-in behind these functions.

  skeleton(data)            virtual-block plan of a raw DEFLATE stream
                            (the foreign-stream device decode's walk)
  inflate(data, cap)        host decode of a raw stream
  inflate_consumed(data, cap)  the same, plus the input bytes consumed
                            (gzip members)
  parse_headers(data, offs) batched block-header walk (the wavefront
                            decoder's host prep, ops/wave.py)
  deflate(data, level)      host encode (compress(backend="native"))
  stitch(segments)          bit-level concatenation of encoded segments
  adler32(data)             the zlib container's checksum
  rfc_tables(which)         the RFC 1951 tables as each source holds them

``build_asan_fuzz()`` builds asan_fuzz.cpp, a fuzz driver of the entry
points that parse untrusted bytes, under ASan and UBSan.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRCS = [os.path.join(_HERE, f) for f in ("inflate.cpp", "deflate.cpp")]
BUILD = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
HINT_STRIDE = 4224            # hint bytes per virtual block: the largest
                              # wave bucket (models/wave_decoder.BUCKETS)

DT_OK = 0
DT_ERRORS = {
    -1: "truncated or malformed stream",
    -2: "output capacity exceeded",
    -3: "invalid Huffman code or code lengths",
    -4: "distance too far back",
    -5: "reserved block type",
}

_lock = threading.Lock()
_lib = None


def _compile(name: str, flags, srcs, suffix: str) -> str:
    """g++ srcs with flags into _build/<name>_<hash><suffix>, the hash
    over the flags and the sources, unless that file exists; returns its
    path.  Raises on failure."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in srcs:
        with open(src, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD, f"{name}_{digest.hexdigest()[:12]}{suffix}")
    if not os.path.exists(out):
        os.makedirs(BUILD, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        r = subprocess.run([os.environ.get("CXX", "g++"), *flags, "-o", tmp,
                            *srcs], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ of {name} failed:\n{r.stderr}")
        os.replace(tmp, out)
    return out


def build() -> str:
    """Compile inflate.cpp and deflate.cpp into one library unless a
    current one exists; returns its path.  Raises on failure."""
    return _compile("libdeflate", CXX_FLAGS, SRCS, ".so")


ASAN_FLAGS = ["-O1", "-g", "-std=c++17", "-fsanitize=address,undefined",
              "-fno-sanitize-recover=all"]
FUZZ_SRC = os.path.join(_HERE, "asan_fuzz.cpp")


def build_asan_fuzz() -> str:
    """Compile the ASan/UBSan fuzz driver (asan_fuzz.cpp) over
    inflate.cpp and deflate.cpp unless a current build exists; returns
    the executable's path in _build/.  Run it with no arguments: it
    exits 0 and prints "asan_fuzz ok=..." when no sanitizer fired.
    Raises on a failed build."""
    return _compile("asan_fuzz", ASAN_FLAGS, [FUZZ_SRC] + SRCS, "")


def lib() -> ctypes.CDLL:
    """The loaded library, building it at first use."""
    global _lib
    with _lock:
        if _lib is None:
            L = ctypes.CDLL(build())
            u8p = ctypes.POINTER(ctypes.c_uint8)
            szp = ctypes.POINTER(ctypes.c_size_t)
            i64p = ctypes.POINTER(ctypes.c_int64)
            L.dt_inflate.restype = ctypes.c_int
            L.dt_inflate.argtypes = [ctypes.c_char_p, ctypes.c_size_t, u8p,
                                     ctypes.c_size_t, szp]
            L.dt_skeleton.restype = ctypes.c_int
            L.dt_skeleton.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_int64, ctypes.c_int64, i64p,
                                      u8p, i64p, i64p]
            i32p = ctypes.POINTER(ctypes.c_int32)
            L.dt_parse_headers.restype = ctypes.c_int
            L.dt_parse_headers.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                           i64p, ctypes.c_int64, i64p, i64p,
                                           i64p, u8p, i32p, i32p, u8p]
            L.dt_inflate2.restype = ctypes.c_int
            L.dt_inflate2.argtypes = [ctypes.c_char_p, ctypes.c_size_t, u8p,
                                      ctypes.c_size_t, szp, szp]
            L.dt_deflate.restype = ctypes.c_int
            L.dt_deflate.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                     ctypes.c_int, u8p, ctypes.c_size_t, szp]
            L.dt_adler32.restype = ctypes.c_uint32
            L.dt_adler32.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            for name in ("dt_rfc_tables_inflate", "dt_rfc_tables_deflate"):
                f = getattr(L, name)
                f.restype = None
                f.argtypes = [i32p] * 5
            u32p = ctypes.POINTER(ctypes.c_uint32)
            u64p = ctypes.POINTER(ctypes.c_uint64)
            L.dt_stitch.restype = None
            L.dt_stitch.argtypes = [u32p, u64p, u64p, ctypes.c_size_t, u32p]
            _lib = L
        return _lib


def inflate(data: bytes, out_cap: int, exact: bool = False) -> bytes:
    """Native inflate; returns bytes or raises ValueError.

    exact=True treats out_cap as a hard cap (the caller declared the
    output size): capacity overflow is an error.  exact=False treats it
    as a hint and grows geometrically, bounded at 1 GiB (a conforming
    DEFLATE stream cannot exceed 1032x expansion)."""
    L = lib()
    limit = min(1 << 30, max(out_cap, 1040 * max(1, len(data)) + 64))
    while True:
        out = (ctypes.c_uint8 * out_cap)()
        out_len = ctypes.c_size_t(0)
        rc = L.dt_inflate(data, len(data), out, out_cap,
                          ctypes.byref(out_len))
        if rc == DT_OK:
            return bytes(bytearray(out)[:out_len.value])
        if rc == -2 and not exact and out_cap < limit:
            out_cap = min(out_cap * 4, limit)
            continue
        raise ValueError(f"inflate: {DT_ERRORS.get(rc, rc)}")


def inflate_consumed(data: bytes, out_cap: int):
    """Native inflate returning (bytes, input bytes consumed), for
    container parsers (multi-member gzip) that must find the trailer or
    the next member after the DEFLATE payload.  Grows out_cap as a hint,
    as inflate does; raises ValueError on a malformed stream."""
    L = lib()
    limit = min(1 << 30, max(out_cap, 1040 * max(1, len(data)) + 64))
    while True:
        out = (ctypes.c_uint8 * out_cap)()
        out_len = ctypes.c_size_t(0)
        consumed = ctypes.c_size_t(0)
        rc = L.dt_inflate2(data, len(data), out, out_cap,
                           ctypes.byref(out_len), ctypes.byref(consumed))
        if rc == DT_OK:
            return bytes(bytearray(out)[:out_len.value]), consumed.value
        if rc == -2 and out_cap < limit:
            out_cap = min(out_cap * 4, limit)
            continue
        raise ValueError(f"inflate: {DT_ERRORS.get(rc, rc)}")


def deflate(data: bytes, level: int) -> bytes:
    """Native deflate (dt_deflate in deflate.cpp) of data at level 0-3 to
    a raw DEFLATE stream."""
    L = lib()
    out_cap = max(1024, len(data) + len(data) // 2 + 4096)
    out = (ctypes.c_uint8 * out_cap)()
    out_len = ctypes.c_size_t(0)
    rc = L.dt_deflate(data, len(data), level, out, out_cap,
                      ctypes.byref(out_len))
    if rc != DT_OK:
        raise ValueError(f"deflate: {DT_ERRORS.get(rc, rc)}")
    return bytes(bytearray(out)[:out_len.value])


def adler32(data: bytes) -> int:
    return int(lib().dt_adler32(data, len(data)))


def rfc_tables(which: str) -> dict:
    """The RFC 1951 constant tables as compiled into one source, which:
    "inflate" or "deflate": int32 arrays len_base, len_extra, dist_base,
    dist_extra, cl_order, for tests that hold the copies of these
    constants (utils/tables.py, inflate.cpp, deflate.cpp) against each
    other."""
    fn = getattr(lib(), f"dt_rfc_tables_{which}")
    tabs = {"len_base": 29, "len_extra": 29, "dist_base": 30,
            "dist_extra": 30, "cl_order": 19}
    out = {k: np.zeros(n, np.int32) for k, n in tabs.items()}
    fn(*(a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
         for a in out.values()))
    return out


def stitch(segments) -> tuple[np.ndarray, int]:
    """Bit-level concatenation of [(uint32 words, nbits), ...] (dt_stitch
    in inflate.cpp): returns (uint32 words [total // 32 + 2], total
    bits).  Bits past nbits in a segment's last word must be zero."""
    L = lib()
    total = sum(int(nb) for _, nb in segments)
    segs = [np.ascontiguousarray(w[:(int(nb) + 31) // 32], np.uint32)
            for w, nb in segments]
    cat = np.concatenate(segs) if segs else np.zeros(0, np.uint32)
    offsets = np.zeros(len(segs), np.uint64)
    offsets[1:] = np.cumsum([len(w) for w in segs[:-1]])
    bits = np.asarray([int(nb) for _, nb in segments], np.uint64)
    out = np.zeros(total // 32 + 2, np.uint32)
    p = ctypes.POINTER
    L.dt_stitch(cat.ctypes.data_as(p(ctypes.c_uint32)),
                offsets.ctypes.data_as(p(ctypes.c_uint64)),
                bits.ctypes.data_as(p(ctypes.c_uint64)), len(segs),
                out.ctypes.data_as(p(ctypes.c_uint32)))
    return out, total


def parse_headers(data: bytes, bit_offsets):
    """Batched block-header walk (dt_parse_headers in inflate.cpp): for
    each block at bit_offsets, its btype, data_start (absolute bit of
    the first symbol or stored payload), stored_len, err (a parse
    failure), hlit, hdist and the raw code lengths lens [B, 320]
    (litlen then dist, zero padded), as numpy arrays.  The canonical
    decode metadata is built from them by ops/wave._canon_meta_batch."""
    L = lib()
    offs = np.ascontiguousarray(bit_offsets, np.int64)
    B = len(offs)
    btype = np.zeros(B, np.int64)
    dstart = np.zeros(B, np.int64)
    slen = np.zeros(B, np.int64)
    err = np.zeros(B, np.uint8)
    hlit = np.zeros(B, np.int32)
    hdist = np.zeros(B, np.int32)
    lens = np.zeros((B, 320), np.uint8)
    p = ctypes.POINTER
    L.dt_parse_headers(
        data, len(data), offs.ctypes.data_as(p(ctypes.c_int64)), B,
        btype.ctypes.data_as(p(ctypes.c_int64)),
        dstart.ctypes.data_as(p(ctypes.c_int64)),
        slen.ctypes.data_as(p(ctypes.c_int64)),
        err.ctypes.data_as(p(ctypes.c_uint8)),
        hlit.ctypes.data_as(p(ctypes.c_int32)),
        hdist.ctypes.data_as(p(ctypes.c_int32)),
        lens.ctypes.data_as(p(ctypes.c_uint8)))
    return {"btype": btype, "data_start": dstart, "stored_len": slen,
            "err": err.astype(bool), "hlit": hlit, "hdist": hdist,
            "lens": lens}


def skeleton(data: bytes):
    """Skeleton walk of a raw DEFLATE stream: the virtual-block index and
    decode hints of the wavefront device decoder (dt_skeleton in
    inflate.cpp).  Works on any conforming stream.

    Returns dict(parent_bit, start_bit, out_len, flags, span_bits,
    out_start, btype — int64 [n_vb]; hints uint8 [n_vb, HINT_STRIDE];
    total_out int).  Raises ValueError on malformed streams."""
    L = lib()
    # every vb covers >= 1 output byte or >= one stored block; a
    # conforming stream of n bytes can't exceed ~1032x expansion (the
    # walk reports a full table, and the loop grows it)
    max_vb = max(64, min(2 * len(data) + 16,
                         (1040 * len(data)) // 32768 + 16))
    i64p = ctypes.POINTER(ctypes.c_int64)
    while True:
        meta = np.zeros((max_vb, 8), np.int64)
        hints = np.zeros((max_vb, HINT_STRIDE), np.uint8)
        n_vb = ctypes.c_int64(0)
        total = ctypes.c_int64(0)
        rc = L.dt_skeleton(
            data, len(data), max_vb, HINT_STRIDE,
            meta.ctypes.data_as(i64p),
            hints.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(n_vb), ctypes.byref(total))
        if rc == -2 and max_vb < 1 << 22:
            max_vb *= 4
            continue
        if rc != DT_OK:
            raise ValueError(f"skeleton: {DT_ERRORS.get(rc, rc)}")
        m = meta[:n_vb.value]
        return {"parent_bit": m[:, 0].copy(), "start_bit": m[:, 1].copy(),
                "out_len": m[:, 2].copy(), "flags": m[:, 3].copy(),
                "span_bits": m[:, 4].copy(), "out_start": m[:, 5].copy(),
                "btype": m[:, 6].copy(), "hints": hints[:n_vb.value].copy(),
                "total_out": total.value}
