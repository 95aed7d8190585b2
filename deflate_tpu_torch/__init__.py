"""deflate_tpu_torch — the DEFLATE codec in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of ``deflate_tpu`` (JAX/Pallas), held bit-for-bit against it.  This
package imports ``torch`` and never ``jax`` or ``deflate_tpu``.

Main path (level-2 manifest encode, then wavefront device decode):

    from deflate_tpu_torch.runtime import manifest as M
    stream, man = M.compress_with_manifest(data, level=2, device=dev)
    out = M.decode_all(stream, man, device=dev)

``device`` is a ``torch.device``.  On a CUDA device every kernel of the
path (ops/tree.py, ops/wave_stagea.py, ops/wave_route.py, ops/wave_fill.py)
launches its CUDA C++ kernel from ``csrc/``, built by ``_build.py`` at
first use; on the CPU each takes its plain PyTorch version.
"""
