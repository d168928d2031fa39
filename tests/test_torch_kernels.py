"""The port's kernel wrappers on CPU tensors (their plain versions) against
the reference's Pallas kernels in interpret mode, on the same numpy inputs,
at the tolerances of ``repro_torch.kernels.ops.TOLERANCE`` (the reference
suite's own, tests/test_kernels.py:22-23 and :36)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.masked_sgd import masked_sgd as jax_masked_sgd
from repro.kernels.weighted_agg import MAX_SINGLE_K
from repro.kernels.weighted_agg import weighted_agg as jax_weighted_agg
from repro_torch.kernels import ops
from repro_torch.kernels.weighted_agg import VECTOR_BYTES, padded, row_stride


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside the other test workers, a pool of
    threads per process oversubscribes the cores, and its idle threads
    spin, slowing every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _as_float(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("layout", ["contiguous", "padded"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("K,D", [(5, 4099), (MAX_SINGLE_K + 6, 4099)])
def test_weighted_agg_matches_pallas(K, D, dtype, layout):
    """K=5 takes the reference's single-block layout, K=70 its K-tiled
    one; D=4099 is ragged against every block size.  "padded" is the
    layout the CUDA kernel reads, rows of whole 16-byte vectors."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(K + D)
    c = rng.uniform(size=K).astype(np.float32)
    d = rng.normal(size=(K, D)).astype(np.float32)
    td = torch.from_numpy(d).to(tdt)
    if layout == "padded":
        td = padded(td)
        assert td.stride(0) == row_stride(D, tdt) > D
        assert td.stride(0) * td.element_size() % VECTOR_BYTES == 0
    before = dict(ops.launches)
    got = ops.weighted_agg(torch.from_numpy(c), td)
    want = jax_weighted_agg(jnp.asarray(c), jnp.asarray(d, jdt),
                            interpret=True)
    assert got.dtype == torch.float32 and got.shape == (D,)
    np.testing.assert_allclose(got.numpy(), _as_float(want),
                               **ops.TOLERANCE["weighted_agg"][tdt])
    assert ops.launches == before      # a CPU tensor launches no kernel


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_masked_sgd_scalar_matches_pallas(dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    w = rng.normal(size=5000).astype(np.float32)
    g = rng.normal(size=5000).astype(np.float32)
    # torch.tensor copies: masked_sgd writes into w, and the numpy w must
    # stay as it was for the reference's call
    got = ops.masked_sgd(torch.tensor(w, dtype=tdt),
                         torch.tensor(g, dtype=tdt), torch.tensor(0.05))
    want = jax_masked_sgd(jnp.asarray(w, jdt), jnp.asarray(g, jdt),
                          jnp.float32(0.05), interpret=True)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), _as_float(want),
                               **ops.TOLERANCE["masked_sgd"][tdt])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_masked_sgd_per_row_matches_pallas_row_by_row(dtype):
    """The (C, n) form with one scale per client row (zero rows included:
    a masked step) equals the Pallas kernel's scalar form on each row."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    w = rng.normal(size=(4, 1001)).astype(np.float32)
    g = rng.normal(size=(4, 1001)).astype(np.float32)
    s = np.array([0.1, 0.0, 0.25, 1e-3], np.float32)
    got = ops.masked_sgd(torch.tensor(w, dtype=tdt),
                         torch.tensor(g, dtype=tdt), torch.from_numpy(s))
    for r in range(4):
        want = jax_masked_sgd(jnp.asarray(w[r], jdt), jnp.asarray(g[r], jdt),
                              jnp.float32(s[r]), interpret=True)
        np.testing.assert_allclose(got[r].float().numpy(), _as_float(want),
                                   **ops.TOLERANCE["masked_sgd"][tdt])
    # alpha = 0 leaves the row exactly as it was
    assert torch.equal(got[1], torch.from_numpy(w[1]).to(tdt))


@pytest.mark.parametrize("call", [
    lambda: ops.weighted_agg(torch.ones(3), torch.ones(4, 5)),
    lambda: ops.weighted_agg(torch.ones(3), torch.ones(3, 5, 1)),
    lambda: ops.weighted_agg(torch.ones(3, dtype=torch.float64),
                             torch.ones(3, 5)),
    lambda: ops.weighted_agg(torch.ones(3), torch.ones(3, 5,
                                                        dtype=torch.int32)),
    lambda: ops.masked_sgd(torch.ones(3, 5), torch.ones(3, 4),
                           torch.ones(3)),
    lambda: ops.masked_sgd(torch.ones(3, 5), torch.ones(3, 5),
                           torch.ones(2)),
    lambda: ops.masked_sgd(torch.ones(5), torch.ones(5, dtype=torch.bfloat16),
                           torch.ones(())),
    lambda: ops.masked_sgd(torch.ones(5), torch.ones(5),
                           torch.ones((), dtype=torch.float64)),
])
def test_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises((ValueError, TypeError)):
        call()
