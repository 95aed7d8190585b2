"""ctypes bindings of the native host walk (native/inflate.cpp).

The source is a copy of deflate_tpu/native/inflate.cpp.  At first use it
is compiled with ``g++ -O2 -shared -fPIC`` into the gitignored
``deflate_tpu_torch/_build/``, named by a hash of the source and flags
so an edited source rebuilds.  A failed build raises: there is no
pure-Python stand-in behind these functions.

  skeleton(data)            virtual-block plan of a raw DEFLATE stream
                            (the foreign-stream device decode's walk)
  inflate(data, cap)        host decode of a raw stream
  parse_headers(data, offs) batched block-header walk (the wavefront
                            decoder's host prep, ops/wave.py)
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "inflate.cpp")
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


def _target() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD, f"libinflate_{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Compile inflate.cpp unless a current library exists; returns its
    path.  Raises on failure."""
    so = _target()
    if not os.path.exists(so):
        os.makedirs(BUILD, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        r = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS,
                            "-o", tmp, SRC], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ inflate.cpp failed:\n{r.stderr}")
        os.replace(tmp, so)
    return so


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
