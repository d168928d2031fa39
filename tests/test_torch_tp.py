"""Tensor and expert parallelism over the model axis (``repro_torch.models``
under ``models.sharding.use_mesh``, ``models.params.shard_params``,
``launch.mesh``, ``launch.cluster``) in serving, against the reference's
single-device run: a sharded program computes the function of the
unsharded one, so the reference's jax forward on the same weights is what
the ranks are held to (its own multi-device legs are red under jax 0.9,
ROADMAP Limits item 1).

Every family's reduced config in f32, the same weights in both packages
(the port's draw, ``lm_to_numpy`` for the reference; each rank its shards
of it): gloo worlds of 1, 2 and 4 ranks (``torch.multiprocessing.spawn``,
``file://`` init through ``launch.cluster.init_distributed``), each
started once for the module (``tests/_tp_common.py``; the ranks import no
jax).  At 4 ranks the 2 KV heads of every reduced GQA config are copied
(4 > KV); llava prefills its patches; musicgen serves its 4 codebooks;
deepseek-v3 runs with a nonzero ``router_bias``.

Tolerances: logits within the zoo's BLOCK_TOL (rtol = atol = 1e-5,
``tests/test_torch_lm_zoo.py``); ``_moe_ffn_ep`` within the reference's
1e-5 (``tests/test_moe_ep.py``).  A world of one rank is bit-identical to
the unsharded port.  The gradients are ``test_torch_tp_grad.py``'s."""
import dataclasses

import numpy as np
import pytest
import torch

from _tp_common import (BLOCK_TOL, EP_TOL, MOE_ARCHS, N_DEC, WORLDS, Row,
                        inputs_for, reference_serving, run_worlds)
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import Grid
from repro_torch.models.params import init_params, shard_params


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
    return {arch: reference_serving(arch, inputs[arch]) for arch in ARCH_IDS}


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    return run_worlds(inputs, tmp_path_factory.mktemp("tp"), WORLDS,
                      ("serve", "ep"))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_match_reference(worlds, reference, world, arch):
    """Every rank's prefill and decode logits (replicated: the head's
    blocks gathered) within BLOCK_TOL of the reference's single-device
    forward, and equal on every rank."""
    want = reference[arch]["logits"]
    first = worlds[world][0][arch]["logits"]
    for r, out in enumerate(worlds[world]):
        assert out["coord"] == r
        got = out[arch]["logits"]
        assert len(got) == len(want) == N_DEC + 1
        for g, w in zip(got, want):
            assert g.shape == w.shape and np.isfinite(g).all()
            np.testing.assert_allclose(g, w, **BLOCK_TOL)
        for g, f in zip(got, first):
            np.testing.assert_array_equal(g, f)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_one_rank_is_bit_identical_to_the_unsharded_port(worlds, arch):
    out = worlds[1][0][arch]
    for g, u in zip(out["logits"], out["unsharded"], strict=True):
        np.testing.assert_array_equal(g, u)


def test_grid_refuses_a_world_of_another_size(worlds):
    for world in WORLDS:
        assert f"the world {world}" in worlds[world][0]["mismatch"]


# -- expert parallelism -------------------------------------------------------

@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_ep_matches_the_reference_dense_path(worlds, reference,
                                                     world, arch):
    y, aux = reference[arch]["moe"]["dense"]
    for out in worlds[world]:
        got, got_aux = out[arch]["ep"]
        np.testing.assert_allclose(got, y, **EP_TOL)
        np.testing.assert_allclose(got_aux, aux, **EP_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_ep_one_rank_matches_the_reference_ep(worlds, reference,
                                                      arch):
    """At one rank, against the reference's ``moe_ffn(ep=True)`` under
    ``make_smoke_mesh(1, 1)`` (its shard_map path)."""
    y, aux = reference[arch]["moe"]["ep1"]
    got, got_aux = worlds[1][0][arch]["ep"]
    np.testing.assert_allclose(got, y, **EP_TOL)
    np.testing.assert_allclose(got_aux, aux, **EP_TOL)


# -- the layout ---------------------------------------------------------------

def test_shard_params_refuses_heads_that_do_not_split():
    """Five query heads over 2 model ranks (hymba-1.5b has 25); the KV
    heads of a reduced config (2) over 3."""
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(),
                              n_heads=5, n_kv_heads=1)
    with pytest.raises(ValueError, match="5 query heads"):
        shard_params(init_params(cfg, device="meta"), cfg, Row(2, 0))
    cfg = get_config("nemotron-4-15b").reduced()
    with pytest.raises(ValueError, match="2 KV heads"):
        shard_params(init_params(cfg, device="meta"), cfg, Row(3, 0))


def test_copied_kv_heads_are_the_heads_the_ranks_read():
    """At 4 ranks and 2 KV heads, ranks 0-1 hold a copy of KV head 0 and
    ranks 2-3 of KV head 1 (their query heads 0-1 and 2-3 read those)."""
    cfg = get_config("starcoder2-3b").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    attn = params["blocks"]["attn"]
    hd = cfg.head_dim
    for r in range(4):
        local = shard_params(params, cfg, Row(4, r))["blocks"]["attn"]
        j = r // 2
        for name in ("wk", "wv", "bk", "bv"):
            assert torch.equal(local[name],
                               attn[name][..., j * hd:(j + 1) * hd]), name
        assert torch.equal(local["wq"], attn["wq"][..., r * hd:(r + 1) * hd])


def test_grid_is_laid_row_major_with_model_innermost():
    g = Grid(("pod", "data", "model"), (2, 2, 2), (1, 0, 1),
             {("pod",): "p", ("data",): "d", ("model",): "m",
              ("pod", "data"): "pd"})
    assert g.coord("model") == 1 and g.coord(("pod", "data")) == 2
    assert g.axis_size(("pod", "data")) == 4 and g.size == 8
    assert g.group(("data", "pod")) == "pd"
    with pytest.raises(ValueError, match="no 'x' axis"):
        g.group("x")
