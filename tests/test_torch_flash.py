"""The port's flash_attention wrapper on CPU tensors (its plain version)
against the reference's Pallas kernel in interpret mode and its oracle,
on the same numpy inputs, at the shapes and tolerances of
``tests/test_kernels.py:177-196``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref


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


def _inputs(B, H, KV, S, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, n, S, hd)).astype(np.float32)
              for n in (H, KV, KV)]
    tdt, jdt = DTYPES[dtype]
    return ([torch.tensor(a).to(tdt) for a in arrays],
            [jnp.asarray(a, jdt) for a in arrays])


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,KV,S,hd", [
    (1, 2, 2, 128, 64),
    (2, 4, 2, 256, 64),
    (1, 4, 1, 384, 128),   # MQA
    (2, 2, 2, 100, 32),    # S not a multiple of the tile
    (1, 4, 2, 100, 256),   # gemma's head dim, S ragged
])
def test_flash_attention_matches_reference(B, H, KV, S, hd, dtype, causal):
    (q, k, v), (jq, jk, jv) = _inputs(B, H, KV, S, hd, dtype)
    before = dict(ops.launches)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.launches == before          # CPU tensors launch nothing
    assert got.shape == q.shape and got.dtype == q.dtype
    tol = ops.TOLERANCE["flash_attention"][DTYPES[dtype][0]]
    kernel = jops.flash_attention(jq, jk, jv, causal=causal, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(kernel), **tol)
    rep = H // KV
    oracle = jref.flash_attention_ref(jq, jnp.repeat(jk, rep, 1),
                                      jnp.repeat(jv, rep, 1), causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(oracle), **tol)
    # ref names the plain version the kernel is held against on the card
    torch.testing.assert_close(ref.flash_attention_ref(q, k, v, causal), got,
                               rtol=0, atol=0)


def test_flash_attention_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 2, 8, 96)
    with pytest.raises(ValueError, match="96"):
        ops.flash_attention(x, x, x)
    q, k = torch.zeros(1, 3, 8, 32), torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="multiple of KV"):
        ops.flash_attention(q, k, k)
    with pytest.raises(TypeError):
        ops.flash_attention(k, k.double(), k)
    with pytest.raises(TypeError):
        ops.flash_attention(k.half(), k.half(), k.half())
