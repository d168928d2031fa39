"""``weighted_agg``: the CUDA kernel's launch and its plain PyTorch version.

out[d] = sum_k coeffs[k] * deltas[k, d]   (paper Eq. 2 hot loop)

The kernel (``csrc/weighted_agg.cu``) replaces the Pallas kernel
``repro/kernels/weighted_agg.py:108``; its source says what bounds it and
how its design answers that.  Callers go through
``repro_torch.kernels.ops.weighted_agg``, which picks the kernel for CUDA
tensors and the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_FN = {torch.float32: "weighted_agg_f32", torch.bfloat16: "weighted_agg_bf16"}
_SIGNATURES = {fn: (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_void_p)
               for fn in _FN.values()}
# the kernel reads each row in vectors of this many bytes
VECTOR_BYTES = 16


def row_stride(D: int, dtype: torch.dtype) -> int:
    """The row stride, in elements, of the layout the kernel reads: D
    rounded up to a whole 16-byte vector, so every row starts aligned."""
    vec = VECTOR_BYTES // dtype.itemsize
    return -(-D // vec) * vec


def padded(deltas: torch.Tensor) -> torch.Tensor:
    """deltas (K, D) copied into the layout the kernel reads: the (K, D)
    view of a (K, row_stride(D)) buffer whose pad columns are zero."""
    K, D = deltas.shape
    buf = torch.zeros(K, row_stride(D, deltas.dtype), dtype=deltas.dtype,
                      device=deltas.device)
    buf[:, :D] = deltas
    return buf[:, :D]


def check_args(coeffs: torch.Tensor, deltas: torch.Tensor) -> None:
    """Shapes and dtypes both versions take: coeffs (K,) f32 and deltas
    (K, D) f32 or bf16 on one device."""
    if deltas.dim() != 2 or coeffs.shape != (deltas.shape[0],):
        raise ValueError(f"weighted_agg takes coeffs (K,) and deltas (K, D), "
                         f"got {tuple(coeffs.shape)} and {tuple(deltas.shape)}")
    if coeffs.dtype != torch.float32 or deltas.dtype not in _FN:
        raise TypeError(f"weighted_agg takes f32 coeffs and f32/bf16 deltas, "
                        f"got {coeffs.dtype} and {deltas.dtype}")
    if coeffs.device != deltas.device:
        raise ValueError(f"coeffs on {coeffs.device}, deltas on "
                         f"{deltas.device}")


def weighted_agg_plain(coeffs: torch.Tensor,
                       deltas: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: an f32 sum over k in the
    order 0..K-1, each product and each sum rounded on its own."""
    out = torch.zeros(deltas.shape[1], dtype=torch.float32,
                      device=deltas.device)
    for k in range(deltas.shape[0]):
        out = out + coeffs[k] * deltas[k].float()
    return out


def launch(coeffs: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """One launch of the CUDA kernel on PyTorch's current stream; returns
    the (D,) f32 output.  deltas must be in the layout of ``padded``: rows
    row_stride(D) elements apart, or any stride that is a multiple of a
    16-byte vector.  Raises on arguments the kernel does not take and when
    the launch is refused."""
    if not deltas.is_cuda:
        raise ValueError(f"the weighted_agg kernel takes CUDA tensors, got "
                         f"{deltas.device}")
    K, D = deltas.shape
    ld, size = deltas.stride(0), deltas.element_size()
    # rows of whole 16-byte vectors: the last vector of every row, pad
    # included, must lie inside the tensor's storage
    end = deltas.storage_offset() + (K - 1) * ld + row_stride(D, deltas.dtype)
    if not (coeffs.is_contiguous() and (deltas.stride(1) == 1 or D <= 1)
            and ld % (VECTOR_BYTES // size) == 0 and ld >= D
            and deltas.data_ptr() % VECTOR_BYTES == 0
            and (K == 0 or end * size <= deltas.untyped_storage().nbytes())):
        raise ValueError(
            f"the weighted_agg kernel reads rows of whole 16-byte vectors; "
            f"lay the ({K}, {D}) {deltas.dtype} deltas out with padded() "
            f"(row stride {row_stride(D, deltas.dtype)}), got strides "
            f"{deltas.stride()}")
    out = torch.empty(D, dtype=torch.float32, device=deltas.device)
    fn = getattr(build.load("weighted_agg", _SIGNATURES), _FN[deltas.dtype])
    with torch.cuda.device(deltas.device):
        err = fn(coeffs.data_ptr(), deltas.data_ptr(), ld, out.data_ptr(), K,
                 D, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"weighted_agg launch failed with CUDA error {err}")
    return out
