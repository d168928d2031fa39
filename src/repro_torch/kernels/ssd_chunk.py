"""``ssd_intra_chunk``: the CUDA kernel's launch and its plain PyTorch version.

For each cell g (one batch row, chunk and head of Mamba2's chunked SSD):
y[g] = ((C[g] B[g]^T) * L[g]) xdt[g] with L[g][i, j] = exp(cum[g, i] -
cum[g, j]) for j <= i and 0 above the diagonal; cum (G, Q) f32, C and B
(G, Q, N), xdt (G, Q, P) in f32 or bf16, the output (G, Q, P) in f32.

The kernel (``csrc/ssd_intra_chunk.cu``) replaces the Pallas kernel
``repro/kernels/ssd_chunk.py:43``.  Besides the reference's (G, ...) cells
it takes cells split as (outer, inner), ``cum`` (Go, Gi, Q) and the others
(Go, Gi, Q, ...), each read through its strides with the last dim
contiguous: the heads of one SSD group then read the group's B and C rows
through a stride-0 inner dim (an ``expand`` view), with no per-head copy.
For such cells it writes its output into a (Go, Q, Gi, P) buffer and
returns the (Go, Gi, Q, P) view of it, the layout ``models.ssd`` adds the
inter-chunk term to.  Callers go through
``repro_torch.kernels.ops.ssd_intra_chunk``.

In f32, the serving path's type, the kernel is bound by operations on the
CUDA cores: at the mamba2-130m prefill (cells (64, 24), Q 256, N 128, P
64) the group's scores once per (outer cell, pair j <= i) and each head's
product come to 7.01 GFLOP, 0.105 ms at 67 TFLOP/s, against 0.066 ms for
its bytes.  So where C and B reach the heads through a stride-0 head dim
(``group_shared``) one CTA computes the scores of a query tile once and
applies every head's decay and xdt to them (``heads_per_cta`` says how
many heads it takes); a producer warp stages its tiles by TMA and bulk
copies on mbarriers, and both products are f32 FMA sums in the plain
version's order, which split-precision TF32 on the tensor cores would
not keep within ``ops.TOLERANCE``.  The source says more.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_FN = {torch.float32: "ssd_intra_chunk_f32",
       torch.bfloat16: "ssd_intra_chunk_bf16"}
# the f32 entry also takes the heads per CTA; ssd_intra_chunk_f32_warpgroups
# gives the f32 kernel's consumer warpgroups at a width P
SIGNATURES = {fn: (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * n
              + (ctypes.c_void_p,) for fn, n in zip(_FN.values(), (6, 5))}
SIGNATURES["ssd_intra_chunk_f32_warpgroups"] = (ctypes.c_int,)
MAX_N = 256
WIDE_P = (32, 64, 128)      # P above 16 the kernel takes
MAX_GRID = 2 ** 31 - 1      # the CUDA grid's x limit: cells * query tiles
BQ = 64                     # query rows per CTA


def check_args(cum: torch.Tensor, C: torch.Tensor, B: torch.Tensor,
               xdt: torch.Tensor) -> None:
    """Shapes and dtypes both versions take: cum (G, Q), C and B (G, Q, N),
    xdt (G, Q, P), or the same with the cells as (Go, Gi); cum f32, the
    others one dtype in f32/bf16; N at most MAX_N, P at most 16 or one of
    WIDE_P; one device."""
    cells = cum.shape[:-1]
    if cum.dim() not in (2, 3) or C.shape != B.shape \
            or C.dim() != cum.dim() + 1 or xdt.dim() != C.dim() \
            or C.shape[:-1] != cum.shape or xdt.shape[:-1] != cum.shape:
        raise ValueError(f"ssd_intra_chunk takes cum (G, Q), C and B (G, Q, "
                         f"N), xdt (G, Q, P), or the cells as (Go, Gi), got "
                         f"{tuple(cum.shape)}, {tuple(C.shape)}, "
                         f"{tuple(B.shape)}, {tuple(xdt.shape)}")
    N, P = C.shape[-1], xdt.shape[-1]
    if not (1 <= N <= MAX_N and (1 <= P <= 16 or P in WIDE_P)):
        raise ValueError(f"ssd_intra_chunk takes N in [1, {MAX_N}] and P at "
                         f"most 16 or in {WIDE_P}, got N={N}, P={P} "
                         f"(cells {tuple(cells)})")
    if cum.dtype != torch.float32 or C.dtype not in _FN \
            or B.dtype != C.dtype or xdt.dtype != C.dtype:
        raise TypeError(f"ssd_intra_chunk takes cum in f32 and C, B, xdt of "
                        f"one dtype in f32/bf16, got {cum.dtype}, {C.dtype}, "
                        f"{B.dtype}, {xdt.dtype}")
    if not cum.device == C.device == B.device == xdt.device:
        raise ValueError(f"cum on {cum.device}, C on {C.device}, B on "
                         f"{B.device}, xdt on {xdt.device}")


def ssd_intra_chunk_plain(cum: torch.Tensor, C: torch.Tensor, B: torch.Tensor,
                          xdt: torch.Tensor) -> torch.Tensor:
    """The reference's oracle (``repro/kernels/ref.py:29``) in plain
    PyTorch, for any leading cell dims: everything in f32, the decay taken
    where j <= i and 0 above the diagonal.  The mask comes before the exp
    (-inf there, so no inf meets a zero cotangent): the function is
    differentiable, and the SSD mixer takes it when gradients are being
    taken."""
    cum = cum.float()
    Q = cum.shape[-1]
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=cum.device).tril()
    L = torch.exp(torch.where(mask, diff, -torch.inf))
    s = torch.einsum("...qn,...sn->...qs", C.float(), B.float()) * L
    return torch.einsum("...qs,...sp->...qp", s, xdt.float())


def group_shared(C: torch.Tensor, B: torch.Tensor) -> bool:
    """Whether the f32 kernel computes the scores once for several heads:
    (Go, Gi, Q, N) cells of more than one head whose C and B both come
    through a stride-0 head dim (the model's layout).  Flat cells, and C
    or B shared alone, take one head per CTA."""
    return C.dim() == 4 and C.shape[1] > 1 and C.stride(1) == 0 \
        and B.stride(1) == 0


def heads_per_cta(Go: int, Gi: int, Q: int, shared: bool, n_sm: int,
                  n_wg: int) -> int:
    """The heads one CTA of the f32 kernel takes: 1 unless the heads share
    C and B (``group_shared``); else all Gi of a cell, cut into as few
    blocks as give at least ``n_sm`` CTAs (one per SM), a cut block
    holding a multiple of the kernel's ``n_wg`` consumer warpgroups, which
    take its heads in turn (``ssd_intra_chunk_f32_warpgroups``)."""
    if not shared:
        return 1
    splits = -(-n_sm // (Go * -(-Q // BQ)))
    if splits <= 1:
        return Gi
    heads = -(-Gi // splits)
    return min(Gi, -(-heads // n_wg) * n_wg)


def _strides(t: torch.Tensor, name: str, last_contiguous: bool = True):
    """(outer, inner, row) element strides of a (Go, Gi, Q[, n]) view."""
    if last_contiguous and t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"the ssd_intra_chunk kernel reads {name} with its "
                         f"last dim contiguous, got strides {t.stride()}")
    return t.stride()[:3]


def launch(cum: torch.Tensor, C: torch.Tensor, B: torch.Tensor,
           xdt: torch.Tensor, lib=None, heads: int | None = None
           ) -> torch.Tensor:
    """One launch of the CUDA kernel on PyTorch's current stream; returns
    the f32 output, (G, Q, P), or for (Go, Gi) cells the (Go, Gi, Q, P)
    view of a (Go, Q, Gi, P) buffer.  Raises on arguments the kernel does
    not take and when the launch is refused.  ``lib`` is the library to
    launch from, by default the one built from ``csrc/ssd_intra_chunk.cu``;
    another one (opened with ``SIGNATURES``) must have the same C
    interface.  ``heads`` sets the f32 kernel's heads per CTA, by default
    ``heads_per_cta``'s choice (above 1 only where ``group_shared``)."""
    if not C.is_cuda:
        raise ValueError(f"the ssd_intra_chunk kernel takes CUDA tensors, got "
                         f"{C.device}")
    split = cum.dim() == 3
    if split:
        Go, Gi, Q = cum.shape
        out = torch.empty(Go, Q, Gi, xdt.shape[-1], dtype=torch.float32,
                          device=C.device).transpose(1, 2)
    else:
        (Go, Q), Gi = cum.shape, 1
        out = torch.empty(Go, Q, xdt.shape[-1], dtype=torch.float32,
                          device=C.device)
        cum, C, B, xdt, out = (t.unsqueeze(1) for t in (cum, C, B, xdt, out))
    N, P = C.shape[-1], xdt.shape[-1]
    if Go * Gi * -(-Q // BQ) > MAX_GRID:
        raise ValueError(f"ssd_intra_chunk takes at most {MAX_GRID} cells "
                         f"times query tiles, got {Go * Gi} cells of Q={Q}")
    strides = (ctypes.c_int64 * 15)(
        *_strides(cum, "cum", False), *_strides(C, "C"), *_strides(B, "B"),
        *_strides(xdt, "xdt"), *_strides(out, "out"))
    lib = lib or build.load("ssd_intra_chunk", SIGNATURES)
    args = [Go, Gi, Q, N, P]
    if C.dtype == torch.float32:
        if heads is None:
            n_sm = torch.cuda.get_device_properties(
                C.device).multi_processor_count
            heads = heads_per_cta(Go, Gi, Q, group_shared(C, B), n_sm,
                                  lib.ssd_intra_chunk_f32_warpgroups(P))
        args.append(heads)
    with torch.cuda.device(C.device):
        err = getattr(lib, _FN[C.dtype])(
            cum.data_ptr(), C.data_ptr(), B.data_ptr(), xdt.data_ptr(),
            out.data_ptr(), ctypes.cast(strides, ctypes.c_void_p), *args,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ssd_intra_chunk launch failed with CUDA error "
                           f"{err}")
    return out if split else out.squeeze(1)
