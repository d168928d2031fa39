"""The port's models against the reference's on the same parameters and
inputs: logits, per-client losses and per-client gradients of logistic
regression, the MLP and the CNN, with the reference's parameters carried
across by ``repro_torch.params.from_jax`` (and back by ``to_numpy``).

Tolerance: f32 throughout, rtol 1e-5 / atol 1e-6 — both frameworks compute
in f32 on the CPU and differ only in summation order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper import EMNIST_CNN, MNIST_MLP, SYNTHETIC_LR
from repro.models.small import init_small, logits_small, make_loss_fn
from repro_torch.configs import paper as port_configs
from repro_torch.models import small as port
from repro_torch.params import from_jax, to_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside the other test workers, a pool of
    threads per process oversubscribes the cores, and its idle threads
    spin, slowing every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-6)
CONFIGS = {"logreg": SYNTHETIC_LR, "mlp": MNIST_MLP, "cnn": EMNIST_CNN}


def _port_cfg(cfg):
    return port_configs.PAPER_CONFIGS[cfg.name]


def _inputs(cfg, C, B, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(C, B, *cfg.input_shape)).astype(np.float32)
    y = rng.integers(0, cfg.n_classes, size=(C, B)).astype(np.int32)
    return x, y


def _jax_params(cfg, c):
    return {k: np.asarray(v) for k, v in
            init_small(jax.random.PRNGKey(c), cfg).items()}


def _stack(per_client, cfg):
    """Per-client reference params -> the port's (C, ...) client stack."""
    ported = [from_jax(p, _port_cfg(cfg), "cpu") for p in per_client]
    return {k: torch.stack([p[k] for p in ported]) for k in ported[0]}


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_logits_loss_and_grads_match_reference(kind):
    """Two clients with different params and inputs in one batched call,
    each against the reference's single-model functions."""
    cfg = CONFIGS[kind]
    C, B = 2, 4
    x, y = _inputs(cfg, C, B, seed=len(kind))
    jparams = [_jax_params(cfg, c) for c in range(C)]
    stack = {k: v.requires_grad_() for k, v in _stack(jparams, cfg).items()}
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    logits = port.logits_clients(stack, _port_cfg(cfg), batch["x"])
    losses = port.make_loss_fn(_port_cfg(cfg))(stack, batch)
    grads = dict(zip(stack, torch.autograd.grad(losses.sum(),
                                                list(stack.values()))))
    jloss = make_loss_fn(cfg)
    for c in range(C):
        jb = {"x": jnp.asarray(x[c]), "y": jnp.asarray(y[c])}
        np.testing.assert_allclose(
            logits[c].detach().numpy(),
            np.asarray(logits_small(jparams[c], cfg, jb["x"])), **TOL)
        want_loss, want_grad = jax.value_and_grad(jloss)(jparams[c], jb)
        np.testing.assert_allclose(losses[c].item(), float(want_loss), **TOL)
        got_grad = to_numpy({k: g[c] for k, g in grads.items()},
                            _port_cfg(cfg))
        for k in want_grad:
            np.testing.assert_allclose(got_grad[k], np.asarray(want_grad[k]),
                                       err_msg=k, **TOL)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_params_round_trip_exactly(kind):
    cfg = CONFIGS[kind]
    jp = _jax_params(cfg, 3)
    back = to_numpy(from_jax(jp, _port_cfg(cfg), "cpu"), _port_cfg(cfg))
    assert sorted(back) == sorted(jp)
    for k in jp:
        assert back[k].shape == jp[k].shape
        np.testing.assert_array_equal(back[k], jp[k])


def test_single_model_logits_and_accuracy():
    cfg = EMNIST_CNN
    jp = _jax_params(cfg, 5)
    x, y = _inputs(cfg, 1, 6, seed=5)
    params = from_jax(jp, _port_cfg(cfg), "cpu")
    got = port.logits_small(params, _port_cfg(cfg), torch.from_numpy(x[0]))
    want = np.asarray(logits_small(jp, cfg, jnp.asarray(x[0])))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    acc = port.accuracy(params, _port_cfg(cfg), torch.from_numpy(x[0]),
                        torch.from_numpy(y[0]))
    assert acc.item() == np.mean(want.argmax(-1) == y[0])


def test_port_init_has_reference_shapes_and_is_seeded():
    for kind, cfg in CONFIGS.items():
        pcfg = _port_cfg(cfg)
        a = port.init_small(pcfg, seed=0, device="cpu")
        b = port.init_small(pcfg, seed=0, device="cpu")
        ref = to_numpy(a, pcfg)
        jp = _jax_params(cfg, 0)
        assert {k: v.shape for k, v in ref.items()} == \
            {k: v.shape for k, v in jp.items()}, kind
        assert all(torch.equal(a[k], b[k]) for k in a)
