"""Optimizers, counterpart of ``repro/optim/sgd.py``.  The paper's federated
path uses vanilla SGD with the staircase learning rate (its local steps
live in ``core.fed_step``, through the ``masked_sgd`` kernel); ``sgd_step``
and AdamW serve the non-federated training utilities.

Parameters, gradients and states are nested dicts of tensors, mapped leaf
by leaf as the reference maps its pytrees; each update is taken in f32 and
rounded to the parameter's dtype.  The functions return new trees and
leave their arguments as they were.
"""
from __future__ import annotations

import torch


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def staircase_lr(eta0: float, tau, tau0=0) -> torch.Tensor:
    """eta0 / max(tau - tau0, 1) in f32, a 0-d tensor (the reference's
    jnp scalar)."""
    steps = torch.as_tensor(tau - tau0, dtype=torch.float32)
    # a tensor divided, not a scalar: PyTorch takes scalar / tensor as the
    # reciprocal times the scalar, another rounding
    return torch.tensor(eta0, dtype=torch.float32) / torch.clamp(steps,
                                                                 min=1.0)


def sgd_step(params, grads, eta, momentum_state=None, momentum: float = 0.0):
    """w - eta * g (with ``momentum`` and a state: m = momentum * m + g,
    then w - eta * m).  Returns (params, momentum_state)."""
    if momentum and momentum_state is not None:
        momentum_state = _map(lambda m, g: momentum * m + g.float(),
                              momentum_state, grads)
        params = _map(lambda p, m: (p.float() - eta * m).to(p.dtype),
                      params, momentum_state)
        return params, momentum_state
    params = _map(lambda p, g: (p.float() - eta * g.float()).to(p.dtype),
                  params, grads)
    return params, momentum_state


def adamw_init(params):
    z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": _map(z, params), "v": _map(z, params),
            "t": torch.zeros((), dtype=torch.int32)}


def adamw_step(params, grads, state, lr, b1=0.9, b2=0.95, eps=1e-8,
               wd=0.01):
    """One AdamW step (bias-corrected moments, decoupled weight decay).
    Returns (params, state)."""
    t = state["t"] + 1
    m = _map(lambda m, g: b1 * m + (1 - b1) * g.float(), state["m"], grads)
    v = _map(lambda v, g: b2 * v + (1 - b2) * g.float().square(),
             state["v"], grads)
    tf = t.float()
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** tf
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** tf

    def upd(p, m_, v_):
        step = (m_ / bc1.to(m_.device)) / (torch.sqrt(v_ / bc2.to(v_.device))
                                           + eps)
        p32 = p.float()
        return (p32 - lr * (step + wd * p32)).to(p.dtype)

    return _map(upd, params, m, v), {"m": m, "v": v, "t": t}
