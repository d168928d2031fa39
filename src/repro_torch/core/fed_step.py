"""The federated round (Eq. 1-2) in the equivalent view (App. A.1.1).

Counterpart of ``repro/core/fed_step.py``, in its two modes.
Client-parallel: all C clients of a round train at once as one batched
computation (the written-out form of the reference's ``jax.vmap`` over
clients): each leaf holds the C clients' copies as one (C, ...) tensor,
one backward pass gives every client its own gradient, and each of the E
steps updates every leaf with one ``masked_sgd`` launch scaled per client
by eta * alpha[c, e].  Client-sequential: the clients train one at a time
(C = 1 of the same batched code) into a streaming accumulator, so only
the global params, the accumulator and one client's delta exist at once.

Local updates are vanilla SGD (the paper's optimizer) with the staircase
learning rate supplied per round; each step is masked by alpha[c, e] in
{0, 1}, so s_tau^k = sum_e alpha[c, e].

The round takes a flat dict of leaves and a loss that returns per-client
losses.  A model whose parameters are a nested tree (the LMs) goes through
``flatten_tree`` (its leaves keyed by path, so that ``sorted`` visits them
in jax's leaf order) and ``per_client_loss`` (a one-client loss over the
tree made into the round's (C,) loss); the flat dict's tensors are the
tree's, so the round's in-place update lands in the tree.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch

from repro_torch.core.aggregation import (accumulate_delta,
                                          aggregate_deltas,
                                          aggregate_deltas_compressed_ref,
                                          aggregate_deltas_flat,
                                          apply_accumulator,
                                          scheme_coefficients)
from repro_torch.core.compression import (resolve_compression,
                                          round_trip_tree)
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]


def flatten_tree(tree) -> Params:
    """A nested dict of tensors -> a flat dict of the same tensors keyed by
    their "/"-joined paths, in jax's leaf order (sorted keys at every
    level), which ``sorted`` of the keys keeps: every key's characters sort
    after "/"."""
    flat = {}

    def walk(t, prefix):
        for k in sorted(t):
            if isinstance(t[k], dict):
                walk(t[k], f"{prefix}{k}/")
            else:
                flat[prefix + k] = t[k]
    walk(tree, "")
    if list(flat) != sorted(flat):
        raise ValueError("a key of the tree sorts before '/': its leaves' "
                         "paths would not keep jax's order")
    return flat


def unflatten_tree(flat: Params) -> dict:
    """``flatten_tree``'s inverse."""
    tree = {}
    for path, leaf in flat.items():
        *outer, last = path.split("/")
        node = tree
        for k in outer:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def per_client_loss(loss_fn: Callable) -> Callable:
    """loss_fn(tree, batch) -> scalar, one client's loss over a nested
    parameter tree -> the round's loss(leaves, batches) -> (C,) over
    ``flatten_tree``'s leaves and batches with a leading client axis.

    The clients run one after another (each through ``unbind`` views of
    the stacked leaves, one backward node per leaf), the written-out form
    of the reference's ``vmap`` of its per-client loss: the LM forward
    (the MoE's sort-and-scatter dispatch into a fresh buffer, the cache
    code's in-place writes) is not written for ``torch.func.vmap``, and one
    client at a time does each client's arithmetic exactly as alone."""
    def loss(leaves: Params, batches) -> torch.Tensor:
        names = list(leaves)
        cols = [leaves[name].unbind(0) for name in names]
        rows = {k: b.unbind(0) for k, b in batches.items()}
        return torch.stack([
            loss_fn(unflatten_tree({name: col[c]
                                    for name, col in zip(names, cols)}),
                    {k: r[c] for k, r in rows.items()})
            for c in range(len(cols[0]))])
    return loss


def local_sgd(loss_fn: Callable, params: Params, batches, alpha: torch.Tensor,
              eta: torch.Tensor) -> Params:
    """E masked SGD steps on all C clients from the global params.

    loss_fn(params, batch) -> (C,) per-client losses with a leading client
    axis on params and batch (``models.small.make_loss_fn``); batches:
    dict of (C, E, ...) tensors, one batch per local step; alpha: (C, E)
    f32 masks; eta: f32 scalar tensor.  Returns the client deltas
    w_E - w_0, leaves (C, ...) f32.
    """
    C, E = alpha.shape
    names = sorted(params)
    # every client starts from the global params; the (C, ...) copies are
    # rewritten in place by masked_sgd at each step.  A clone, not
    # .contiguous(): at C = 1 the expanded view is already contiguous, and
    # the steps would write into the caller's params
    w = {name: params[name].expand(C, *params[name].shape).clone(
        memory_format=torch.contiguous_format) for name in names}
    for e in range(E):
        with torch.enable_grad():
            leaves = {name: w[name].detach().requires_grad_()
                      for name in names}
            loss = loss_fn(leaves, {k: b[:, e] for k, b in batches.items()})
            # a leaf the loss does not reach (the sigmoid router's bias,
            # read only through top-k's indices) takes a zero gradient, as
            # in jax
            grads = torch.autograd.grad(loss.sum(),
                                        [leaves[name] for name in names],
                                        materialize_grads=True)
        # (eta * a) * g, the reference's order of operations
        scale = eta * alpha[:, e]
        for name, g in zip(names, grads):
            ops.masked_sgd(w[name].view(C, -1),
                           g.reshape(C, -1).contiguous(), scale)
    deltas = {}
    for name in names:
        d = w[name].float()
        # the copies are dead after this: an f32 leaf becomes its delta in
        # place
        deltas[name] = d.sub_(params[name].float())
    return deltas


def _squares(deltas: Params) -> torch.Tensor:
    """sum over leaves of sum(x^2), leaf by leaf in name order, as the
    reference sums its pytree's leaves."""
    return sum(deltas[name].square().sum() for name in sorted(deltas))


def fed_round_parallel(loss_fn: Callable, params: Params, batches,
                       alpha: torch.Tensor, coeffs: torch.Tensor,
                       eta: torch.Tensor, *, agg: str = "tree",
                       compression=None,
                       model_kind: Optional[str] = None,
                       sharding=None, with_metrics: bool = False):
    """batches: dict of (C, E, ...) tensors; alpha: (C, E); coeffs: (C,).
    Returns (new params, metrics); the new params are written into
    ``params`` in place.

    agg selects the aggregation layout: "tree" reduces leaf by leaf in
    plain PyTorch; "flat" flattens the deltas into one (C, D_total) buffer
    and reduces it with a single kernel launch.

    compression: optional CompressionSpec/str: the client deltas go
    through the wire format right after the local steps.  On the flat
    layout the weighted_agg_quant kernel takes the int8 payload as it is
    (bf16: a cast into weighted_agg); on the tree layout the plain
    reference round-trips the same quantization lattice.  model_kind: the
    paper model's ``kind``, which fixes the quantized wire's element order
    (``core.aggregation.flatten_for_wire``).

    sharding: optional ``fed.sharding.FedSharding``; batches, alpha and
    coeffs are then this rank's share of the client axis, and the
    aggregation sums every rank's deltas into the replicated params.

    metrics: ``delta_norm``, the L2 norm of all clients' deltas with
    ``with_metrics`` (under sharding, of every rank's), else 0.0.  As in
    the reference, this round takes the norm of the raw deltas, before
    the wire format; the sequential round takes it after."""
    spec = resolve_compression(compression)
    deltas = local_sgd(loss_fn, params, batches, alpha, eta)
    metrics = {"delta_norm": 0.0}
    if with_metrics:
        # before the aggregation, which may reuse the delta buffers
        dn2 = _squares(deltas)
        if sharding is not None:
            dn2 = sharding.all_reduce(dn2)
        metrics["delta_norm"] = dn2.sqrt()
    if agg == "flat":
        new = aggregate_deltas_flat(params, deltas, coeffs, compression=spec,
                                    model_kind=model_kind, sharding=sharding)
    elif agg != "tree":
        raise ValueError(f"agg must be tree|flat, got {agg!r}")
    elif spec.active:
        new = aggregate_deltas_compressed_ref(
            params, deltas, coeffs, spec, model_kind, sharding=sharding)
    else:
        new = aggregate_deltas(params, deltas, coeffs, sharding=sharding)
    return new, metrics


def fed_round_sequential(loss_fn: Callable, params: Params, batches,
                         alpha: torch.Tensor, coeffs: torch.Tensor,
                         eta: torch.Tensor, *, compression=None,
                         model_kind: Optional[str] = None,
                         with_metrics: bool = False):
    """Same contract as fed_round_parallel, with the clients taken one at a
    time to bound memory: only the global params, the f32 accumulator and
    ONE client's delta exist at once, never a (C, D_total) buffer or a
    C-fold copy of the params.  Client c runs ``local_sgd`` on its one-row
    slice of ``batches`` and ``alpha``; on an active wire its delta is
    round-tripped through the wire format on the parallel path's element
    order and chunk grid (``core.compression.round_trip_tree``); then
    ``acc += coeffs[c] * delta`` for c = 0..C-1, from zero, each product
    and sum rounded on its own.  The new params (params + acc) are written
    into ``params`` in place.

    So on a quantized wire this round equals the flat client-parallel
    round (``agg="flat"``) bit for bit wherever the local steps of one
    client equal its row of the C-client steps: the flat reduction adds
    c_k * dequantized row k in the same order.  ``delta_norm`` (with
    ``with_metrics``) sums each client's squares after the wire's round
    trip, as the reference does: the parallel round's norm is of the raw
    deltas.  This mode is not sharded yet (ROADMAP item 6)."""
    spec = resolve_compression(compression)
    acc = {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for name, p in params.items()}
    dn2 = 0.0
    for c in range(alpha.shape[0]):
        delta = local_sgd(loss_fn, params,
                          {k: b[c:c + 1] for k, b in batches.items()},
                          alpha[c:c + 1], eta)
        delta = {name: d[0] for name, d in delta.items()}
        if spec.active:
            delta = round_trip_tree(delta, spec, model_kind)
        if with_metrics:
            dn2 = dn2 + _squares(delta)
        accumulate_delta(acc, delta, coeffs[c])
        del delta
    metrics = {"delta_norm": (torch.as_tensor(dn2, dtype=torch.float32)
                              .sqrt() if with_metrics else 0.0)}
    return apply_accumulator(params, acc), metrics


def make_fed_round(loss_fn: Callable, mode: str = "client_parallel",
                   agg: str = "tree", compression=None,
                   model_kind: Optional[str] = None) -> Callable:
    """Returns fed_round(params, batches, alpha, coeffs, eta) -> (new
    params, metrics), in ``mode`` client_parallel (with ``agg``) or
    client_sequential."""
    if mode == "client_parallel":
        return functools.partial(fed_round_parallel, loss_fn, agg=agg,
                                 compression=compression,
                                 model_kind=model_kind)
    if mode != "client_sequential":
        raise ValueError(f"mode must be client_parallel|client_sequential, "
                         f"got {mode!r}")
    return functools.partial(fed_round_sequential, loss_fn,
                             compression=compression, model_kind=model_kind)


def fed_train_step(loss_fn: Callable, cfg, params: Params, batches,
                   alpha: torch.Tensor, p_weights, eta,
                   scheme: Optional[str] = None, mode: Optional[str] = None):
    """One-call round: the scheme's coefficients from the realized s =
    alpha.sum(-1) (``scheme`` and ``mode`` default to ``cfg.fed``'s), then
    ``make_fed_round(loss_fn, mode)``'s round.  Returns (new params,
    metrics); the new params are written into ``params`` in place."""
    scheme = scheme or cfg.fed.scheme
    mode = mode or cfg.fed.mode
    s = alpha.sum(-1)
    f32 = dict(dtype=torch.float32, device=s.device)
    coeffs = scheme_coefficients(scheme, torch.as_tensor(p_weights, **f32),
                                 s, cfg.fed.local_epochs)
    return make_fed_round(loss_fn, mode)(params, batches, alpha, coeffs,
                                         torch.as_tensor(eta, **f32))
