"""``transformer.train_loss``'s gradients under tensor and expert
parallelism (the model axis's ``copy_to_model``/``reduce_from_model``
pair, vocab-parallel embedding and head, copied KV heads, the SSM's
sharded gated norm, the MoE's expert-parallel gates) against
``jax.grad`` of the reference's loss on one device: every family's
reduced config in f32, the same weights in both packages, 2 gloo ranks
(``tests/_tp_common.py``), each rank's gradient of every leaf it holds
against the reference's gradient cut as that rank's shard.

Tolerance: each leaf within DELTA_TOL (1e-4) of the reference leaf's
norm, after the elements at most two ulps apart are set aside where they
are at most FLIP_SHARE (1%) of the leaf (``tests/test_torch_lm_train.py``);
a leaf whose exact gradient is zero (musicgen's key bias, no rotary
embeddings) is rounding noise on both sides and is held to zero within
ZERO_ATOL of the model's largest gradient."""
import numpy as np
import pytest
import torch

from _tp_common import (GRAD_WORLD, Row, close_grad, inputs_for,
                        reference_grads, run_worlds)
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.fed_step import flatten_tree, unflatten_tree
from repro_torch.models.params import shard_params


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs():
    return {arch: inputs_for(arch) for arch in ARCH_IDS}


@pytest.fixture(scope="module")
def reference(inputs):
    return {arch: reference_grads(arch, inputs[arch]) for arch in ARCH_IDS}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return run_worlds(inputs, tmp_path_factory.mktemp("tpg"), (GRAD_WORLD,),
                      ("grads",))[GRAD_WORLD]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_loss_gradients_match_jax_grad(ranks, reference, arch):
    cfg = get_config(arch).reduced()
    want_full = reference[arch]
    top = max(np.abs(g.numpy()).max() for g in want_full.values())
    for out in ranks:
        want = flatten_tree(shard_params(
            unflatten_tree(want_full), cfg, Row(GRAD_WORLD, out["coord"])))
        got = out[arch]["grads"]
        assert sorted(got) == sorted(want)
        for name, g in got.items():
            assert g.shape == tuple(want[name].shape), name
            close_grad(name, g, want[name].numpy(), top)
