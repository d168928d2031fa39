"""Aggregation schemes (paper §4.1) and the generalized FedAvg update.

Counterpart of ``repro/core/aggregation.py``.  Eq. (2):
``w <- w + sum_k p_tau^k (w_k - w)`` with round-varying p_tau^k.

Scheme A: only complete devices (s=E), p_tau^k = N p^k / K_tau (round
          dropped if K_tau = 0).
Scheme B: accept partial work, fixed p_tau^k = p^k.
Scheme C: debiased, p_tau^k = (E / s_tau^k) p^k (0 when inactive).

Parameters are dicts of tensors; a client-stacked dict has a leading
client axis C on every leaf.  Leaves are visited in sorted-key order,
which is ``jax.tree.leaves`` order for a dict, so the flat (C, D) buffer
lays the leaves out as the reference's does.

Under ``sharding=`` (``fed.sharding.FedSharding``) the deltas and
coefficients are this rank's share of the client axis; every layout
reduces it locally and then sums one (D,) f32 buffer over the federation
axis, one all-reduce per round, which leaves the params replicated.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.compression import (compress_flat, resolve_compression,
                                          round_trip)
from repro_torch.kernels import ops
from repro_torch.kernels.weighted_agg import padded, row_stride
from repro_torch.params import reference_order

Params = Dict[str, torch.Tensor]


def scheme_coefficients(scheme: str, p, s, E: int) -> torch.Tensor:
    """p: (C,) static data weights p^k; s: (C,) completed epochs.
    Returns p_tau: (C,) f32 aggregation coefficients."""
    p = torch.as_tensor(p, dtype=torch.float32)
    s = torch.as_tensor(s, dtype=torch.float32, device=p.device)
    if scheme == "A":
        complete = (s >= E).float()
        K = complete.sum()
        # N is the number of devices in the objective (p > 0), not the
        # buffer length: capacity slots carry empty columns with p = 0
        N = (p > 0).float().sum()
        return torch.where(K > 0, N * p * complete / torch.clamp(K, min=1.0),
                           0.0)
    if scheme == "B":
        return p * (s > 0)
    if scheme == "C":
        return torch.where(s > 0, E * p / torch.clamp(s, min=1.0), 0.0)
    raise ValueError(f"unknown scheme {scheme}")


def theta_bound(scheme: str, n_clients: int, E: int) -> float:
    """Assumption 3.5 upper bound p_tau^k / p^k <= theta."""
    return {"A": float(n_clients), "B": 1.0, "C": float(E)}[scheme]


def _apply(params: Params, update: Dict[str, torch.Tensor]) -> Params:
    """params[k] <- params[k] + update[k] (f32, rounded to the leaf's
    dtype), in place: the previous round's params are dead once the
    deltas exist, so the new ones take their memory."""
    for name, p in params.items():
        p.add_(update[name].reshape(p.shape))
    return params


def aggregate_deltas(params: Params, deltas: Params, coeffs: torch.Tensor,
                     *, sharding=None) -> Params:
    """w + sum_k c_k delta_k over a stacked client axis, leaf by leaf.
    deltas: leaves (C, ...) f32; coeffs: (C,).  Updates params in place.
    Under ``sharding`` the per-leaf sums of this rank's clients go into
    one (D,) buffer, summed over the federation axis at once."""
    c = coeffs.float()
    update = {
        name: (c.reshape((-1,) + (1,) * (d.dim() - 1)) * d.float()).sum(0)
        for name, d in deltas.items()}
    if sharding is None:
        return _apply(params, update)
    return _apply_flat(params, sharding.all_reduce(
        torch.cat([update[name].reshape(-1) for name in sorted(update)])))


def flatten_client_deltas(deltas: Params) -> torch.Tensor:
    """Client-stacked dict (leaves (C, ...)) -> one (C, D_total) f32
    buffer, leaves concatenated in sorted-key order.  The buffer is the
    (C, D_total) view of rows padded with zeros to whole 16-byte vectors,
    the layout the weighted_agg kernel reads (``weighted_agg.padded``)."""
    leaves = [deltas[name] for name in sorted(deltas)]
    C = leaves[0].shape[0]
    D = sum(leaf[0].numel() for leaf in leaves)
    pad = torch.zeros(C, row_stride(D, torch.float32) - D,
                      device=leaves[0].device)
    return torch.cat([leaf.reshape(C, -1).float() for leaf in leaves]
                     + [pad], dim=1)[:, :D]


def flatten_for_wire(params: Params, deltas: Params, spec,
                     model_kind: Optional[str] = None):
    """The client deltas as the flat (C, D_total) buffer the wire ``spec``
    carries, and the gather that takes a (D_total,) vector in that order
    back to the port's (None where it is the port's order).

    A quantized wire cuts the buffer into chunks of one scale each, so its
    elements lie in the reference's order for a model of ``model_kind``
    (``PaperModelConfig.kind``, ``params.reference_order``): the CNN's conv
    weights and ``w1`` rows, which the port keeps in another layout, are
    gathered into the reference's, and the chunks, scales and codes are the
    reference's.  Without a kind the buffer keeps the port's order, which
    is the reference's for every kind but the CNN.  The f32 and bf16 wires
    are elementwise and keep the port's order."""
    flat = flatten_client_deltas(deltas)
    order = (reference_order(params, model_kind)
             if spec.quantized and model_kind else None)
    if order is None:
        return flat, None
    return flat[:, order[0]], order[1]


def _apply_flat(params: Params, agg: torch.Tensor) -> Params:
    """params <- params + agg, the (D_total,) update cut into the leaves in
    sorted-key order.  Updates params in place."""
    update, off = {}, 0
    for name in sorted(params):
        n = params[name].numel()
        update[name] = agg[off:off + n]
        off += n
    return _apply(params, update)


def aggregate_deltas_flat(params: Params, deltas: Params,
                          coeffs: torch.Tensor, *,
                          compression=None,
                          model_kind: Optional[str] = None,
                          sharding=None) -> Params:
    """Same contract as aggregate_deltas, but the whole model is flattened
    into one (C, D_total) buffer and reduced with ONE kernel launch
    (instead of one scaled sum per leaf).  Updates params in place.

    compression: optional CompressionSpec/str (core.compression).  The
    int8 kinds quantize the flat buffer, in the reference's element order
    (``flatten_for_wire``, for the model of ``model_kind``), and reduce the
    (payload, scales) pair with one weighted_agg_quant launch, which
    dequantizes in registers; bf16 casts the buffer into the bf16 rows
    weighted_agg reads.

    sharding: this rank's clients are reduced by the sharded form of the
    same kernel (``weighted_agg_sharded``, ``weighted_agg_quant_sharded``):
    one local launch, then one all-reduce of the f32 partial.  The
    quantizer works per row, so a rank's payload and scales are its rows
    of the unsharded wire."""
    spec = resolve_compression(compression)
    flat, inverse = flatten_for_wire(params, deltas, spec, model_kind)
    coeffs = coeffs.float()
    if spec.quantized:
        payload, scales = compress_flat(flat, spec)
        if sharding is None:
            agg = ops.weighted_agg_quant(coeffs, payload, scales,
                                         chunk=spec.chunk)
        else:
            agg = ops.weighted_agg_quant_sharded(
                coeffs, payload, scales, chunk=spec.chunk, sharding=sharding)
        agg = agg[:flat.shape[1]]
    else:
        if spec.kind == "bf16":
            flat = padded(flat, torch.bfloat16)
        agg = (ops.weighted_agg(coeffs, flat) if sharding is None else
               ops.weighted_agg_sharded(coeffs, flat, sharding=sharding))
    return _apply_flat(params, agg if inverse is None else agg[inverse])


def aggregate_deltas_compressed_ref(params: Params, deltas: Params,
                                    coeffs: torch.Tensor,
                                    compression,
                                    model_kind: Optional[str] = None, *,
                                    sharding=None) -> Params:
    """Plain reference for the compressed flat reduction: quantize ->
    dequantize -> matrix-vector product on the same flat layout and chunk
    grid as the kernel path; only the f32 reduction order differs.  The
    tree path's compressed round (``agg="tree"``).  Updates params in
    place.  Under ``sharding`` the product of this rank's rows is summed
    over the federation axis."""
    spec = resolve_compression(compression)
    flat, inverse = flatten_for_wire(params, deltas, spec, model_kind)
    agg = coeffs.float() @ round_trip(flat, spec)
    if sharding is not None:
        agg = sharding.all_reduce(agg)
    return _apply_flat(params, agg if inverse is None else agg[inverse])


def accumulate_delta(acc: Params, delta: Params, coeff) -> Params:
    """Streaming form for the client-sequential mode: acc += c * delta, in
    place, in f32.  The product and the sum are rounded each on its own
    (two passes, never a fused multiply-add), the arithmetic of the flat
    reduction's kernels, which add c_k * delta_k to their f32 sum in the
    order k = 0..K-1.  coeff: a Python number or a 0-d tensor."""
    c = torch.as_tensor(coeff, dtype=torch.float32,
                        device=next(iter(acc.values())).device)
    for name, a in acc.items():
        a.add_(c * delta[name].float())
    return acc


def apply_accumulator(params: Params, acc: Params) -> Params:
    """params <- params + acc (f32, rounded to the leaf's dtype), in
    place."""
    return _apply(params, acc)


def expected_coeff_stats(scheme: str, p: np.ndarray, trace_samples,
                         E: int, n_rounds: int = 2000, seed: int = 0):
    """Monte-Carlo estimates of E[p_tau^k s_tau^k] etc. used by the theory
    module (learning-rate scale, z_tau detection).  trace_samples(rng) must
    return s: (C,) for one round.  A host statistic: the coefficients are
    computed on CPU tensors, in f32 as on the device."""
    rng = np.random.default_rng(seed)
    C = len(p)
    ps_sum = np.zeros(C)
    for _ in range(n_rounds):
        s = trace_samples(rng)
        c = scheme_coefficients(scheme, p, s, E).numpy()
        ps_sum += c * s
    Eps = ps_sum / n_rounds
    ratio = Eps / np.maximum(p, 1e-12)
    z = float(np.std(ratio) > 1e-6 * max(1.0, np.mean(np.abs(ratio))))
    return {"E_ps": Eps, "ratio": ratio, "z": z,
            "E_sum_ps": float(np.sum(Eps))}
