"""The port's aggregation against the reference's: scheme coefficients
A/B/C (empty p=0 capacity columns and s=0 clients included), the flat
(C, D) buffer layout, and flat against tree aggregation in both packages.

Tolerances: scheme coefficients are the same f32 operations in the same
order, so they agree to 1 ulp (rtol 1.2e-7); aggregated params are f32
sums in another order, rtol 1e-6 / atol 1e-7."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper import EMNIST_CNN, MNIST_MLP, SYNTHETIC_LR
from repro.core.aggregation import (aggregate_deltas, aggregate_deltas_flat,
                                    flatten_client_deltas,
                                    scheme_coefficients)
from repro.models.small import init_small
from repro_torch.configs import paper as port_configs
from repro_torch.core import aggregation as port
from repro_torch.kernels.weighted_agg import VECTOR_BYTES, row_stride
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


CONFIGS = {"logreg": SYNTHETIC_LR, "mlp": MNIST_MLP, "cnn": EMNIST_CNN}
AGG_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("scheme", ["A", "B", "C"])
@pytest.mark.parametrize("E", [1, 5])
def test_scheme_coefficients_match_reference(scheme, E):
    rng = np.random.default_rng(E)
    n = rng.integers(50, 400, size=10).astype(np.float64)
    n[[2, 7]] = 0                  # empty capacity columns: p = 0
    p = (n / n.sum()).astype(np.float32)
    for _ in range(5):
        s = rng.integers(0, E + 1, size=10).astype(np.float32)
        s[0] = 0                   # an inactive client
        got = port.scheme_coefficients(scheme, p, s, E)
        want = scheme_coefficients(scheme, jnp.asarray(p), jnp.asarray(s), E)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1.2e-7, atol=0)
    # a round where no device did any work aggregates nothing
    s = np.zeros(10, np.float32)
    assert port.scheme_coefficients(scheme, p, s, E).abs().sum() == 0


def test_unknown_scheme_raises():
    with pytest.raises(ValueError):
        port.scheme_coefficients("D", np.ones(2), np.ones(2), 5)


def _deltas(cfg, C, seed):
    """Reference-layout client deltas (C, ...) and params, from numpy."""
    rng = np.random.default_rng(seed)
    params = {k: np.asarray(v) for k, v in
              init_small(jax.random.PRNGKey(seed), cfg).items()}
    deltas = {k: (1e-2 * rng.normal(size=(C, *v.shape))).astype(np.float32)
              for k, v in params.items()}
    return params, deltas


def _port_stack(deltas, cfg):
    """Reference-layout client deltas -> the port's layout, client by
    client (the converter is per model)."""
    pcfg = port_configs.PAPER_CONFIGS[cfg.name]
    C = next(iter(deltas.values())).shape[0]
    per = [from_jax({k: v[c] for k, v in deltas.items()}, pcfg, "cpu")
           for c in range(C)]
    return {k: torch.stack([p[k] for p in per]) for k in per[0]}


@pytest.mark.parametrize("kind", ["logreg", "mlp"])
def test_flat_buffer_is_the_reference_layout(kind):
    """For leaves whose layout the converter leaves alone, the (C, D) buffer
    equals the reference's column for column: sorted-key leaf order."""
    cfg = CONFIGS[kind]
    _, deltas = _deltas(cfg, 3, seed=1)
    got = port.flatten_client_deltas(_port_stack(deltas, cfg))
    want = flatten_client_deltas({k: jnp.asarray(v)
                                  for k, v in deltas.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_flat_buffer_rows_start_on_16_bytes(kind):
    """The (C, D) buffer is a view of rows padded with zeros to whole
    16-byte vectors, the layout the weighted_agg kernel reads."""
    cfg = CONFIGS[kind]
    _, deltas = _deltas(cfg, 3, seed=1)
    got = port.flatten_client_deltas(_port_stack(deltas, cfg))
    D = got.shape[1]
    assert got.stride() == (row_stride(D, torch.float32), 1)
    assert got.stride(0) * 4 % VECTOR_BYTES == 0
    full = got.as_strided((3, got.stride(0)), got.stride())
    assert torch.count_nonzero(full[:, D:]) == 0


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_flat_and_tree_aggregation_match_reference(kind):
    cfg = CONFIGS[kind]
    pcfg = port_configs.PAPER_CONFIGS[cfg.name]
    C = 4
    params, deltas = _deltas(cfg, C, seed=2)
    coeffs = np.array([0.5, 0.0, 1.25, 0.3], np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jd = {k: jnp.asarray(v) for k, v in deltas.items()}
    want_tree = aggregate_deltas(jp, jd, jnp.asarray(coeffs))
    want_flat = aggregate_deltas_flat(jp, jd, jnp.asarray(coeffs),
                                      interpret=True)
    pd = _port_stack(deltas, cfg)
    got_tree = port.aggregate_deltas(from_jax(params, pcfg, "cpu"), pd,
                                     torch.from_numpy(coeffs))
    got_flat = port.aggregate_deltas_flat(from_jax(params, pcfg, "cpu"), pd,
                                          torch.from_numpy(coeffs))
    for got, want in ((got_tree, want_tree), (got_flat, want_flat),
                      (got_flat, want_tree)):
        got = to_numpy(got, pcfg)
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       err_msg=k, **AGG_TOL)
