"""Client-delta compression: the wire format behind ``compression=``.

Counterpart of ``repro/core/compression.py``.  Every round ships one delta
per sampled client into the aggregator; this module defines what goes on
that wire:

  none       f32 deltas, the uncompressed baseline (4 bytes/elem).
  bf16       plain bfloat16 cast (2 bytes/elem, no scales): the
             weighted_agg kernel reads bf16 rows and sums them in f32.
  int8       per-chunk symmetric quantization: the flat delta row is cut
             into ``chunk``-wide groups, each stored as int8 codes in
             [-levels, +levels] plus ONE f32 scale = absmax/levels.
  int8-topk  per-row magnitude top-k before the int8 path: only
             ``topk_frac`` of the entries survive, the rest quantize to 0.

Quantization runs on the flat (C, D_total) buffer of
``core.aggregation.flatten_for_wire``: leaves in sorted-key order, each in
the reference's element order.  For logistic regression and the MLP that
is the port's own layout; the CNN's conv weights and ``w1`` rows lie in
another order in the port (``repro_torch.params``) and are gathered into
the reference's, so every model's chunk grid and codes are the
reference's.

Bit for bit, the codes and scales are the reference's on the same flat
buffer, and the card's are the CPU's: the scale is max(absmax/levels,
2^-126) where absmax > 0 and 0 otherwise, the codes are
clip(round_half_even(x/scale), -levels, levels), and every division is by
a tensor on the operand's own device (on CUDA, PyTorch computes a division
by a Python number as a multiply by its reciprocal, which rounds twice).
XLA on the CPU and the TPU reads subnormal f32 inputs as zero; the
quantizer flushes them explicitly, so it does the same on every device.

Error contract: for every element of a chunk with stored scale s,
|x - dequant(quant(x))| <= s/2; zero chunks store scale 0 and round-trip
exactly.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.weighted_agg import VECTOR_BYTES, padded

# Smallest normal f32: the scale floor that keeps round(x/scale) finite
# and the <= scale/2 error bound valid for small chunk maxima.
_SCALE_FLOOR = 2.0 ** -126

KINDS = ("none", "bf16", "int8", "int8-topk")


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """Static description of the delta wire format."""
    kind: str = "none"
    chunk: int = 256          # scale-group width along the flat D axis
    levels: int = 127         # int8 code range is [-levels, +levels]
    topk_frac: float = 0.1    # surviving fraction per row (int8-topk)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"compression kind must be one of {KINDS}, "
                             f"got {self.kind!r}")
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        if not 1 <= self.levels <= 127:
            raise ValueError(f"levels must be in [1, 127] (int8 codes), "
                             f"got {self.levels}")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(f"topk_frac must be in (0, 1], "
                             f"got {self.topk_frac}")

    @property
    def quantized(self) -> bool:
        """True for the int8 code paths (payload + scales)."""
        return self.kind in ("int8", "int8-topk")

    @property
    def active(self) -> bool:
        return self.kind != "none"

    @property
    def name(self) -> str:
        """Canonical string form; `resolve_compression` round-trips it."""
        if self.kind == "none":
            return "none"
        opts = []
        if self.quantized:
            if self.chunk != 256:
                opts.append(f"chunk={self.chunk}")
            if self.levels != 127:
                opts.append(f"levels={self.levels}")
            if self.kind == "int8-topk" and self.topk_frac != 0.1:
                opts.append(f"topk={self.topk_frac:g}")
        return self.kind + (":" + ",".join(opts) if opts else "")


def resolve_compression(spec) -> CompressionSpec:
    """None | str | CompressionSpec -> CompressionSpec.

    Strings are ``kind`` or ``kind:opt=v,opt=v`` with opts ``chunk``,
    ``levels``, ``topk``, e.g. ``"int8"``, ``"int8:chunk=128,levels=7"``,
    ``"int8-topk:topk=0.05"``.
    """
    if spec is None:
        return CompressionSpec("none")
    if isinstance(spec, CompressionSpec):
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"compression must be None, str or CompressionSpec, "
                        f"got {type(spec).__name__}")
    kind, _, rest = spec.partition(":")
    kw = {}
    if rest:
        for item in rest.split(","):
            key, _, val = item.partition("=")
            key = key.strip()
            if key == "chunk":
                kw["chunk"] = int(val)
            elif key == "levels":
                kw["levels"] = int(val)
            elif key == "topk":
                kw["topk_frac"] = float(val)
            else:
                raise ValueError(f"unknown compression option {key!r} "
                                 f"in {spec!r}")
    return CompressionSpec(kind.strip(), **kw)


def _flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """x as f32 with subnormal values read as zero, as XLA reads them."""
    x = x.float()
    return x.masked_fill(x.abs() < _SCALE_FLOOR, 0.0)


def quantize_chunked(flat: torch.Tensor, *, chunk: int, levels: int = 127):
    """(K, D) float -> (payload int8 (K, Dp), scales f32 (K, Dp/chunk))
    with Dp = D rounded up to a chunk multiple (zero-padded; zero codes
    contribute nothing downstream).

    Per (row, chunk) group: scale = absmax/levels (floored at 2^-126;
    exactly-zero groups get scale 0 and all-zero codes), payload =
    round(x/scale) clipped to the symmetric code range.  The payload's rows
    start on 16 bytes, the layout the weighted_agg_quant kernel reads: when
    Dp is not a multiple of 16 it is the (K, Dp) view of rows padded with
    zero codes (``weighted_agg.padded``).
    """
    flat = _flush_subnormals(flat)
    K, D = flat.shape
    pad = (-D) % chunk
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    Dp = D + pad
    g = flat.reshape(K, Dp // chunk, chunk)
    absmax = g.abs().amax(-1)
    # made on the device by a fill: a copy from the host would wait for
    # the work queued before it
    levels_t = torch.full((), float(levels), device=flat.device)
    scales = torch.where(absmax > 0,
                         torch.clamp(absmax / levels_t, min=_SCALE_FLOOR),
                         0.0)
    safe = torch.where(scales > 0, scales, 1.0)
    codes = (g / safe[..., None]).round_().clamp_(-levels, levels)
    payload = codes.to(torch.int8).reshape(K, Dp)
    if Dp % VECTOR_BYTES:
        payload = padded(payload)
    return payload, scales


def dequantize_chunked(payload: torch.Tensor, scales: torch.Tensor, *,
                       chunk: int, d: int | None = None) -> torch.Tensor:
    """(K, Dp) int8 + (K, Dp/chunk) f32 -> (K, d or Dp) f32."""
    K, Dp = payload.shape
    out = (payload.float().reshape(K, Dp // chunk, chunk)
           * scales[..., None]).reshape(K, Dp)
    return out if d is None else out[:, :d]


def topk_mask(flat: torch.Tensor, frac: float) -> torch.Tensor:
    """Per-row magnitude top-k keep mask for (K, D) deltas, with
    k = max(1, round(frac*D)); ties at the threshold all survive."""
    D = flat.shape[1]
    k = max(1, min(D, int(round(frac * D))))
    mag = _flush_subnormals(flat).abs()
    # the k-th largest magnitude of each row: the least of its top k
    thresh = torch.topk(mag, k, dim=1, sorted=False).values.amin(1)
    return mag >= thresh[:, None]


def compress_flat(flat: torch.Tensor, spec: CompressionSpec):
    """Quantize a flat (K, D) delta buffer per the spec.

    Returns (payload int8 (K, Dp), scales f32 (K, Dp/chunk)), the pair the
    weighted_agg_quant kernel takes.  Only valid for the int8 kinds; bf16
    has no payload/scale split (it is a plain cast).
    """
    if not spec.quantized:
        raise ValueError(f"compress_flat needs an int8 kind, "
                         f"got {spec.kind!r}")
    if spec.kind == "int8-topk":
        flat = torch.where(topk_mask(flat, spec.topk_frac), flat.float(),
                           0.0)
    return quantize_chunked(flat, chunk=spec.chunk, levels=spec.levels)


def round_trip(flat: torch.Tensor, spec: CompressionSpec) -> torch.Tensor:
    """Quantize-then-dequantize a (K, D) buffer: what the kernel reduces,
    written out in f32.  Identity for kind='none'."""
    if not spec.active:
        return flat.float()
    if spec.kind == "bf16":
        return flat.to(torch.bfloat16).float()
    payload, scales = compress_flat(flat, spec)
    return dequantize_chunked(payload, scales, chunk=spec.chunk,
                              d=flat.shape[1])


def round_trip_tree(delta, spec: CompressionSpec,
                    model_kind: str | None = None):
    """Round-trip one client's delta (a dict of leaves in the params'
    shapes, no client axis) through the wire format; returns a new dict.

    The delta goes through the flat (1, D_total) row of
    ``core.aggregation.flatten_for_wire``, the same element order and chunk
    grid as the client-parallel path's (C, D_total) buffer, the CNN's
    reference-ordered grid included, so the client-sequential accumulator
    quantizes each client exactly as the parallel round does.  Identity
    for kind='none'."""
    if not spec.active:
        return delta
    from repro_torch.core.aggregation import flatten_for_wire
    flat, inverse = flatten_for_wire(
        delta, {name: d[None] for name, d in delta.items()}, spec,
        model_kind)
    rt = round_trip(flat, spec)[0]
    if inverse is not None:
        rt = rt[inverse]
    out, off = {}, 0
    for name in sorted(delta):
        n = delta[name].numel()
        out[name] = rt[off:off + n].reshape(delta[name].shape)
        off += n
    return out


def wire_bytes(D: int, spec, *, n_clients: int = 1) -> int:
    """Analytic bytes on the wire for one round of client->aggregator delta
    traffic.  f32: 4*D per client.  int8: 1 byte per code for the D live
    elements + one f32 scale per chunk (the zero padding to a chunk
    multiple never crosses the wire).  int8-topk: surviving (int8 value,
    int32 index) pairs + the scale slab."""
    spec = resolve_compression(spec)
    if spec.kind == "none":
        per = 4 * D
    elif spec.kind == "bf16":
        per = 2 * D
    else:
        n_chunks = -(-D // spec.chunk)
        if spec.kind == "int8":
            per = D + 4 * n_chunks
        else:
            kept = max(1, min(D, int(round(spec.topk_frac * D))))
            per = kept * (1 + 4) + 4 * n_chunks
    return per * n_clients
