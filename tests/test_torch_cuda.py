"""The CUDA kernels against their plain versions on the card.

These tests need a CUDA device and nvcc; elsewhere they skip.  On the card,
where the reference package's jax is not installed, this file runs alone:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.masked_sgd import masked_sgd_plain
from repro_torch.kernels.weighted_agg import padded, weighted_agg_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import resolve_device
    return resolve_device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,D", [(62, 461630), (62, 461631), (62, 461632),
                                 (100, 4099), (1, 3)])
def test_weighted_agg_kernel_matches_plain(card, K, D, dtype):
    gen = torch.Generator(device=card).manual_seed(K + D)
    c = torch.rand(K, device=card, generator=gen)
    d = padded(torch.randn(K, D, device=card, generator=gen).to(dtype))
    before = ops.launches["weighted_agg"]
    got = ops.weighted_agg(c, d)
    torch.cuda.synchronize()
    assert ops.launches["weighted_agg"] == before + 1
    torch.testing.assert_close(got, weighted_agg_plain(c, d),
                               **ops.TOLERANCE["weighted_agg"][dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(62, 401408), (62, 62), (62, 800),
                                   (16384,), (7,)])
def test_masked_sgd_kernel_matches_plain(card, shape, dtype):
    gen = torch.Generator(device=card).manual_seed(sum(shape))
    w = torch.randn(*shape, device=card, generator=gen).to(dtype)
    g = torch.randn(*shape, device=card, generator=gen).to(dtype)
    s = torch.rand(shape[0] if len(shape) == 2 else 1, device=card,
                   generator=gen)
    before = ops.launches["masked_sgd"]
    got = ops.masked_sgd(w.clone(), g, s)
    torch.cuda.synchronize()
    assert ops.launches["masked_sgd"] == before + 1
    torch.testing.assert_close(got, masked_sgd_plain(w.clone(), g, s),
                               **ops.TOLERANCE["masked_sgd"][dtype])


def test_kernels_refuse_mixed_devices(card):
    with pytest.raises(ValueError):
        ops.weighted_agg(torch.ones(3), torch.ones(3, 5, device=card))


@pytest.mark.parametrize("shape", [(3, 5), (3, 6)])
def test_weighted_agg_kernel_refuses_rows_off_16_bytes(card, shape):
    # rows 5 or 6 f32 apart do not all start on a 16-byte vector
    with pytest.raises(ValueError, match="padded"):
        ops.weighted_agg(torch.ones(3, device=card),
                         torch.ones(*shape, device=card))
    with pytest.raises(ValueError):
        ops.masked_sgd(torch.ones(5, device=card), torch.ones(5, device=card),
                       torch.ones(()))
