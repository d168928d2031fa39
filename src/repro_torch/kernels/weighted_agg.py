"""``weighted_agg`` and ``weighted_agg_quant``: the CUDA kernels' launches
and their plain PyTorch versions.

out[d] = sum_k coeffs[k] * deltas[k, d]   (paper Eq. 2 hot loop)
out[d] = sum_k coeffs[k] * (payload[k, d] * scales[k, d // chunk])
                                          (the same on the int8 wire)

The kernels (``csrc/weighted_agg.cu``, ``csrc/weighted_agg_quant.cu``)
replace the Pallas kernels ``repro/kernels/weighted_agg.py:108`` and
``:187``; their sources say what bounds them and how their designs answer
that.  Callers go through ``repro_torch.kernels.ops``, which picks the
kernel for CUDA tensors and the plain version for CPU tensors.

The sharded forms (``weighted_agg_sharded`` and
``weighted_agg_quant_sharded``, ``repro/kernels/weighted_agg.py:294`` and
``:254``) take one rank's slab of the client axis: the same kernel reduces
it to a (D,) f32 partial, and ``FedSharding.all_reduce`` sums the partials
over the federation axis.  On the TPU too the ``pallas_call`` is the
unsharded kernel and ``lax.psum`` is XLA's collective outside it
(``_local_agg_psum``, ``_local_quant_agg_psum``).
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
QUANT_SIGNATURES = {
    "weighted_agg_quant": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
        ctypes.c_void_p),
    "weighted_agg_quant_plan": (
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int64, ctypes.c_void_p)}
# the kernels read each row in vectors of this many bytes
VECTOR_BYTES = 16


def row_stride(D: int, dtype: torch.dtype) -> int:
    """The row stride, in elements, of the layout the kernel reads: D
    rounded up to a whole 16-byte vector, so every row starts aligned."""
    vec = VECTOR_BYTES // dtype.itemsize
    return -(-D // vec) * vec


def padded(deltas: torch.Tensor, dtype=None) -> torch.Tensor:
    """deltas (K, D) copied, and cast to ``dtype`` if one is given, into the
    layout the kernels read: the (K, D) view of a (K, row_stride(D)) buffer
    whose pad columns are zero."""
    K, D = deltas.shape
    dtype = dtype or deltas.dtype
    buf = torch.zeros(K, row_stride(D, dtype), dtype=dtype,
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


def _rows_of_vectors(rows: torch.Tensor) -> bool:
    """True when every row of the (K, D) tensor starts on a 16-byte vector
    and its last vector, pad included, lies inside the tensor's storage."""
    K, D = rows.shape
    ld, size = rows.stride(0), rows.element_size()
    end = rows.storage_offset() + (K - 1) * ld + row_stride(D, rows.dtype)
    return ((rows.stride(1) == 1 or D <= 1)
            and ld % (VECTOR_BYTES // size) == 0 and ld >= D
            and rows.data_ptr() % VECTOR_BYTES == 0
            and (K == 0 or end * size <= rows.untyped_storage().nbytes()))


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
    ld = deltas.stride(0)
    if not (coeffs.is_contiguous() and _rows_of_vectors(deltas)):
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


def check_quant_args(coeffs: torch.Tensor, payload: torch.Tensor,
                     scales: torch.Tensor, chunk: int) -> None:
    """Shapes and dtypes both versions of weighted_agg_quant take: coeffs
    (K,) f32, payload (K, Dp) int8 with Dp a multiple of chunk, scales
    (K, Dp / chunk) f32, on one device (the reference's messages,
    ``repro/kernels/weighted_agg.py:204-209``)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if payload.dim() != 2 or coeffs.shape != (payload.shape[0],):
        raise ValueError(f"weighted_agg_quant takes coeffs (K,) and payload "
                         f"(K, Dp), got {tuple(coeffs.shape)} and "
                         f"{tuple(payload.shape)}")
    K, Dp = payload.shape
    if Dp % chunk:
        raise ValueError(f"payload width {Dp} not a multiple of the scale "
                         f"chunk {chunk} (quantize_chunked pads)")
    if tuple(scales.shape) != (K, Dp // chunk):
        raise ValueError(f"scales shape {tuple(scales.shape)} != "
                         f"{(K, Dp // chunk)}")
    if coeffs.dtype != torch.float32 or payload.dtype != torch.int8 \
            or scales.dtype != torch.float32:
        raise TypeError(f"weighted_agg_quant takes f32 coeffs, int8 payload "
                        f"and f32 scales, got {coeffs.dtype}, "
                        f"{payload.dtype}, {scales.dtype}")
    if not coeffs.device == payload.device == scales.device:
        raise ValueError(f"coeffs on {coeffs.device}, payload on "
                         f"{payload.device}, scales on {scales.device}")


def weighted_agg_quant_plain(coeffs: torch.Tensor, payload: torch.Tensor,
                             scales: torch.Tensor,
                             chunk: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: row by row, the codes
    times their chunk's scale, times the coefficient, added to an f32 sum
    in the order k = 0..K-1, each product and each sum rounded on its own.
    One dequantized row exists at a time, never a (K, Dp) f32 tensor."""
    K, Dp = payload.shape
    out = torch.zeros(Dp, dtype=torch.float32, device=payload.device)
    for k in range(K):
        row = (payload[k].float().reshape(-1, chunk)
               * scales[k][:, None]).reshape(Dp)
        out = out + coeffs[k] * row
    return out


def launch_quant(coeffs: torch.Tensor, payload: torch.Tensor,
                 scales: torch.Tensor, chunk: int, lib=None) -> torch.Tensor:
    """One launch of the weighted_agg_quant kernel on PyTorch's current
    stream; returns the (Dp,) f32 output.  payload must be in the layout
    ``quantize_chunked`` gives it: rows a multiple of 16 bytes apart (the
    view of ``padded`` when Dp is not a multiple of 16).  ``lib`` is the
    library to launch from (the built one unless given).  Raises on
    arguments the kernel does not take and when the launch is refused."""
    if not payload.is_cuda:
        raise ValueError(f"the weighted_agg_quant kernel takes CUDA tensors, "
                         f"got {payload.device}")
    K, Dp = payload.shape
    if not (coeffs.is_contiguous() and scales.is_contiguous()
            and _rows_of_vectors(payload)):
        raise ValueError(
            f"the weighted_agg_quant kernel reads rows of whole 16-byte "
            f"vectors and contiguous coeffs and scales; lay the ({K}, {Dp}) "
            f"int8 payload out with padded() (row stride "
            f"{row_stride(Dp, torch.int8)}), got strides {payload.stride()}")
    out = torch.empty(Dp, dtype=torch.float32, device=payload.device)
    lib = lib or build.load("weighted_agg_quant", QUANT_SIGNATURES)
    with torch.cuda.device(payload.device):
        err = lib.weighted_agg_quant(
            coeffs.data_ptr(), payload.data_ptr(), payload.stride(0),
            scales.data_ptr(), chunk, out.data_ptr(), K, Dp,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"weighted_agg_quant launch failed with CUDA "
                           f"error {err}")
    return out


def quant_plan(payload: torch.Tensor, scales: torch.Tensor, chunk: int,
               lib=None) -> dict:
    """What a launch of the weighted_agg_quant kernel on these CUDA tensors
    would do, from the kernel's own host code: its path to the scales
    ("staged" beside the codes in shared memory, or "per-code" from device
    memory), the scales it stages per row, rows per TMA box, boxes per
    tile, ring places per group of consumer warps, CTAs and bytes of shared
    memory.  Raises where the kernel would refuse the layout."""
    K, Dp = payload.shape
    plan = (ctypes.c_int * 6)()
    lib = lib or build.load("weighted_agg_quant", QUANT_SIGNATURES)
    with torch.cuda.device(payload.device):
        err = lib.weighted_agg_quant_plan(
            payload.data_ptr(), payload.stride(0), scales.data_ptr(), chunk,
            K, Dp, plan)
    if err:
        raise RuntimeError(f"weighted_agg_quant refuses this layout: CUDA "
                           f"error {err}")
    return dict(path="staged" if plan[0] else "per-code", staged=plan[0],
                rows=plan[1], boxes=plan[2], stages=plan[3], ctas=plan[4],
                smem=plan[5])


def weighted_agg_sharded_plain(coeffs: torch.Tensor, deltas: torch.Tensor,
                               sharding) -> torch.Tensor:
    """weighted_agg_sharded in plain PyTorch: the plain version on this
    rank's (K/n, D) slab, then the sum over the federation axis."""
    return sharding.all_reduce(weighted_agg_plain(coeffs, deltas))


def weighted_agg_quant_sharded_plain(coeffs: torch.Tensor,
                                     payload: torch.Tensor,
                                     scales: torch.Tensor, chunk: int,
                                     sharding) -> torch.Tensor:
    """weighted_agg_quant_sharded in plain PyTorch: the plain version on
    this rank's int8 slab, then the f32 sum over the federation axis."""
    return sharding.all_reduce(
        weighted_agg_quant_plain(coeffs, payload, scales, chunk))
