"""``flash_attention``: the CUDA kernel's launch and its plain PyTorch version.

o = softmax(q k^T / sqrt(hd) [causal mask]) v, per (batch, head), with
grouped-query heads: q (B, H, S, hd), k and v (B, KV, S, hd), query head h
reading KV head h // (H / KV).  The output is (B, H, S, hd) in q's dtype.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas kernel
``repro/kernels/flash_attention.py:64``; its source says what bounds it and
how its design answers that.  It reads q, k and v through their strides
(the head dim contiguous, every row on 16 bytes; in bf16 through TMA tensor
maps that the C entry point builds per launch): the model hands it
transposed views of its (B, S, heads, hd) projections and no copy is made.
It writes its output into a (B, S, H, hd) buffer and returns the
(B, H, S, hd) view of it, so transposing back for the output projection is
free.  Callers go through ``repro_torch.kernels.ops.flash_attention``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_FN = {torch.float32: "flash_attention_f32",
       torch.bfloat16: "flash_attention_bf16"}
SIGNATURES = {fn: (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_float, ctypes.c_void_p)
               for fn in _FN.values()}
HEAD_DIMS = (32, 64, 128, 256)
# the f32 kernel's grid has one row per (b, h), at most the CUDA grid's y
# limit; the bf16 kernel's 1-D grid has no such limit
F32_MAX_BATCH_HEADS = 65535
NEG_INF = -1e30


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Shapes and dtypes both versions take: q (B, H, S, hd), k and v
    (B, KV, S, hd) with H a multiple of KV, hd in HEAD_DIMS, one dtype in
    f32/bf16, one device."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or (q.shape[0], q.shape[2], q.shape[3]) != \
            (k.shape[0], k.shape[2], k.shape[3]) \
            or k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"flash_attention takes q (B, H, S, hd) and k, v "
                         f"(B, KV, S, hd) with H a multiple of KV, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {HEAD_DIMS}, got "
                         f"{q.shape[3]}")
    if q.dtype not in _FN or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes q, k, v of one dtype in "
                        f"f32/bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")


def scale_of(hd: int) -> float:
    """1/sqrt(hd) as the reference computes it, sqrt in f32 and then 1/x in
    f32, as a Python float (exact in f32, so a tensor times it is the
    reference's product, and no device tensor is made for it)."""
    return float(1.0 / torch.sqrt(torch.tensor(float(hd))))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The reference's oracle (``repro/kernels/ref.py:41``) in plain
    PyTorch, KV heads repeated to H: scores in f32, masked to -1e30, a
    softmax in f32, the weights cast to v's dtype, then their product with
    v."""
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    S = q.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * scale_of(q.shape[-1])
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s.masked_fill_(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1)
    del s
    return torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), v)


def _strides(t: torch.Tensor, name: str):
    """(batch, head, position) element strides the kernel reads; raises
    unless the head dim is contiguous and every row starts on 16 bytes."""
    vec = 16 // t.element_size()
    if t.stride(3) != 1 or t.data_ptr() % 16 \
            or any(s % vec for s in t.stride()[:3]):
        raise ValueError(f"the flash_attention kernel reads rows of {name} "
                         f"that start on 16 bytes with the head dim "
                         f"contiguous, got strides {t.stride()}")
    return t.stride()[:3]


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool = True, lib=None) -> torch.Tensor:
    """One launch of the CUDA kernel on PyTorch's current stream; returns
    the (B, H, S, hd) output, a view of a (B, S, H, hd) buffer.  Raises on
    arguments the kernel does not take and when the launch is refused.
    ``lib`` is the library to launch from, by default the one built from
    ``csrc/flash_attention.cu``; another one (opened with ``SIGNATURES``)
    must have the same C interface."""
    if not q.is_cuda:
        raise ValueError(f"the flash_attention kernel takes CUDA tensors, "
                         f"got {q.device}")
    B, H, S, hd = q.shape
    if q.dtype == torch.float32 and B * H > F32_MAX_BATCH_HEADS:
        raise ValueError(f"flash_attention in f32 takes B*H at most "
                         f"{F32_MAX_BATCH_HEADS}, got {B * H}")
    out = torch.empty(B, S, H, hd, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_int64 * 12)(*_strides(q, "q"), *_strides(k, "k"),
                                    *_strides(v, "v"), *_strides(out, "o"))
    lib = lib or build.load("flash_attention", SIGNATURES)
    fn = getattr(lib, _FN[q.dtype])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ctypes.cast(strides, ctypes.c_void_p), B, H, k.shape[1], S,
                 hd, int(causal), scale_of(hd),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed with CUDA error "
                           f"{err}")
    return out

