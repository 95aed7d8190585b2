"""Build and load the CUDA kernels of ``csrc/`` (nvcc -> shared library ->
ctypes).

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process,
all started together, for ``sm_90a`` into ``deflate_tpu_torch/_build/``
(listed in .gitignore), named by a hash of the source so an edited kernel
rebuilds.  Each entry point has a plain C signature: tensors travel as
``data_ptr()`` pointers, the CUDA stream as a pointer, and the function
returns ``cudaGetLastError()`` after its launch, which :func:`check`
turns into an exception.  There is no fallback: without ``nvcc`` or a
card, :func:`lib` raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I = ctypes.c_int

# entry point -> argument types (pointers, ints, then the stream)
SIGNATURES = {
    "tree": {"dt_tree_depths": [P, P, P, I, I, P]},
    "wave_stagea": {"dt_decode_mark": [P, P, P, P, P, P,
                                       I, I, I, I, P]},
    "wave_route": {"dt_route": [P, P, P, P, I, I, I, I, I, P]},
    "wave_fill": {"dt_fill_matches": [P, P, P, P, I, P]},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "deflate_tpu_torch need the CUDA toolkit")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD, f"lib{name}_{digest.hexdigest()[:12]}.so")


def build_all() -> dict[str, str]:
    """Compile every kernel source that has no current library, in
    parallel; returns name -> library path.  Raises on any failure."""
    os.makedirs(BUILD, exist_ok=True)
    out, procs = {}, {}
    for name in SIGNATURES:
        src, so = _target(name)
        out[name] = so
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, so)
    errors = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed:\n{log.decode()}")
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building all at first use."""
    with _lock:
        if name not in _libs:
            paths = build_all()
            for n, path in paths.items():
                cdll = ctypes.CDLL(path)
                for fn, argtypes in SIGNATURES[n].items():
                    f = getattr(cdll, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                _libs[n] = cdll
        return _libs[name]


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: error {err}")


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """All tensors contiguous int32 on one CUDA device; returns it."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"expected CUDA tensors on {dev}, got {t.device}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous int32")
    return dev
