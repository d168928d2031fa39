"""``masked_sgd``: the CUDA kernel's launch and its plain PyTorch version.

w <- w - scale * g   in f32, stored in w's dtype   (paper Eq. 1 with the
A.1.1 alpha mask folded into the scale)

Two forms: w, g of shape (D,) with one scale (the Pallas kernel's), and
w, g of shape (C, n) with one scale per row (the port's local step, one
row per client).  Both versions update ``w`` in place and return it: the
clients' parameter copies are rewritten where they lie instead of being
allocated anew at every step.

The kernel (``csrc/masked_sgd.cu``) replaces the Pallas kernel
``repro/kernels/masked_sgd.py:26``; its source says what bounds it and how
its design answers that.  Callers go through
``repro_torch.kernels.ops.masked_sgd``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_FN = {torch.float32: "masked_sgd_f32", torch.bfloat16: "masked_sgd_bf16"}
_SIGNATURES = {fn: (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int64, ctypes.c_void_p)
               for fn in _FN.values()}
MAX_ROWS = 65535    # the CUDA grid's y limit: one grid row per client


def check_args(w: torch.Tensor, g: torch.Tensor,
               scale: torch.Tensor) -> None:
    """Shapes and dtypes both versions take: w and g of one shape, (D,) or
    (C, n), and one dtype, f32 or bf16; scale f32 of shape () or (1,) for
    (D,), (C,) for (C, n); all on one device."""
    if w.shape != g.shape or w.dim() not in (1, 2):
        raise ValueError(f"masked_sgd takes w and g of one shape, (D,) or "
                         f"(C, n), got {tuple(w.shape)} and {tuple(g.shape)}")
    want = ((1,), ()) if w.dim() == 1 else ((w.shape[0],),)
    if tuple(scale.shape) not in want:
        raise ValueError(f"masked_sgd scale shaped {tuple(scale.shape)} for w "
                         f"shaped {tuple(w.shape)}")
    if w.dtype not in _FN or g.dtype != w.dtype \
            or scale.dtype != torch.float32:
        raise TypeError(f"masked_sgd takes w, g of one dtype in f32/bf16 and "
                        f"an f32 scale, got {w.dtype}, {g.dtype}, "
                        f"{scale.dtype}")
    if not w.device == g.device == scale.device:
        raise ValueError(f"w on {w.device}, g on {g.device}, scale on "
                         f"{scale.device}")


def masked_sgd_plain(w: torch.Tensor, g: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: scale * g, then w minus
    it, in f32, rounded to w's dtype; written into w."""
    s = scale.reshape(-1, 1) if w.dim() == 2 else scale.reshape(())
    return w.copy_(w.float() - s * g.float())


def launch(w: torch.Tensor, g: torch.Tensor,
           scale: torch.Tensor) -> torch.Tensor:
    """One launch of the CUDA kernel on PyTorch's current stream, updating
    w in place.  Raises on arguments the kernel does not take and when the
    launch is refused."""
    if not w.is_cuda:
        raise ValueError(f"the masked_sgd kernel takes CUDA tensors, got "
                         f"{w.device}")
    if not (w.is_contiguous() and g.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("the masked_sgd kernel takes contiguous tensors")
    rows, n = w.shape if w.dim() == 2 else (1, w.shape[0])
    if rows > MAX_ROWS:
        raise ValueError(f"masked_sgd takes at most {MAX_ROWS} rows, "
                         f"got {rows}")
    fn = getattr(build.load("masked_sgd", _SIGNATURES), _FN[w.dtype])
    with torch.cuda.device(w.device):
        err = fn(w.data_ptr(), g.data_ptr(), scale.data_ptr(), rows, n,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"masked_sgd launch failed with CUDA error {err}")
    return w
