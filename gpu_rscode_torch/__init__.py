"""gpu_rscode_torch — Reed-Solomon erasure coding on PyTorch and CUDA.

The port of the JAX package beside it to an NVIDIA H100.  It imports
``torch`` and ``numpy`` and nothing of the JAX package.

Public surface:

- :class:`gpu_rscode_torch.codec.RSCodec` — stripe-level (n, k) codec.
- :func:`gpu_rscode_torch.api.encode_file` /
  :func:`~gpu_rscode_torch.api.decode_file` — file-level encode/decode in
  the reference formats.
- ``python -m gpu_rscode_torch`` — the ``RS`` command line.
- :mod:`gpu_rscode_torch.ops` — GF(2^w) tables, the plain GEMMs, the CUDA
  kernels (``ops/csrc/``: K1 ``gf_gemm.cu``, K2 ``gf_pack2.cu``, K3
  ``gf_planes.cu``) and the host inverse.
- ``python -m gpu_rscode_torch.tools.kernel_sweep`` /
  ``python -m gpu_rscode_torch.tools.expand_probe`` — the kernel-formulation
  measurements (K2, K3, the copy floor, the compute-only ceiling).

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
GPU and no device they raise.
"""

__all__ = ["RSCodec"]
__version__ = "0.1.0"


def __getattr__(name):
    # Lazy, so that `python -m gpu_rscode_torch -h` stays quick.
    if name == "RSCodec":
        from .codec import RSCodec

        return RSCodec
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
