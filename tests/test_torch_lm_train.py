"""The port's LM training pieces against the reference, at each
architecture's ``reduced()`` config in f32 with the reference's own weights
(``repro_torch.params.lm_from_jax``) and the same numpy inputs:
``rmsnorm``'s hand-written backward, ``train_loss`` and its gradients for
one architecture of each family, ``chunked_xent``, ``fed_lm_batches``, the
optimizers, one federated LM round, ``launch/train.py`` and the
forward-only kernel wrappers under grad.

Tolerances: the loss within rtol 1e-5; each gradient leaf within rtol 1e-4
and an atol of 1e-4 x the reference leaf's max |g| (f32 in other summation
orders, carried back through two layers), except a leaf whose exact
gradient is zero (ZERO_GRAD: musicgen's key bias), where that scale is
rounding noise: both packages' values there must be zero to within 1e-6
of the model's largest gradient.  A round's delta per leaf within 1e-4 of
the reference delta's norm; where at most FLIP_SHARE of a leaf's elements
differ, each by at most E + 1 ulps, those elements are set aside first
(see test_fed_round_matches_reference)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.fed_step import make_fed_round as jmake_fed_round
from repro.data import fed_lm_batches as jfed_lm_batches
from repro.models import common as jcommon
from repro.models import transformer as jtransformer
from repro.models.params import init_params as jinit_params
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_step as jadamw_step
from repro.optim import sgd_step as jsgd_step
from repro.optim import staircase_lr as jstaircase_lr
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.fed_step import (flatten_tree, make_fed_round,
                                       per_client_loss, unflatten_tree)
from repro_torch.data import fed_lm_batches
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_chunk import ssd_intra_chunk_plain
from repro_torch.launch import train as train_mod
from repro_torch.models import common, transformer
from repro_torch.optim import adamw_init, adamw_step, sgd_step, staircase_lr
from repro_torch.params import lm_from_jax, lm_to_numpy

KEY = jax.random.PRNGKey(0)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-4          # times the reference leaf's max |g|
DELTA_TOL = 1e-4          # times the reference leaf delta's norm
# each local step and the aggregation round the parameter in f32, so two
# rounds whose updates differ at all put a few elements an ulp apart at
# each of those E + 1 roundings.  Measured on the reduced mamba2-130m:
# 0.1-0.2% of in_B's, in_C's and in_dt's elements, at most 2 ulps, which
# at ~100 ulps of delta an element reads 0.9e-4 to 1.4e-4 of their norms.
# Such elements are set aside when they are at most this share of the
# leaf; a leaf-wide error moves most elements and is held to DELTA_TOL.
FLIP_SHARE = 0.01
# leaves whose exact gradient is zero: without rotary embeddings (which
# rotate it by each key's position) a bias added to every key shifts each
# query's scores by one constant, which the softmax removes
ZERO_GRAD = ("attn/bk",)
ZERO_ATOL = 1e-6          # times the model's largest reference |g|
# one architecture per family: dense with layernorm, dense with rmsnorm
# (its hand-written backward), MLA + MoE + MTP, SSM, hybrid, multimodal
# (patches), audio (K codebook labels)
FAMILIES = ["nemotron-4-15b", "gemma-7b", "deepseek-v3-671b", "mamba2-130m",
            "hymba-1.5b", "llava-next-34b", "musicgen-medium"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return jget_config(arch).reduced(), get_config(arch).reduced()


def _np_params(jcfg):
    # jitted: drawn op by op, deepseek-v3's tree takes ~10 s on the CPU
    return jax.tree.map(np.asarray, jax.jit(jinit_params, static_argnums=1)(
        KEY, jcfg))


def _batch(cfg, B, S, seed):
    """tokens and labels (B, S[, K]) with a few labels masked (-1), and a
    multimodal config's patches (B, P, d)."""
    rng = np.random.default_rng(seed)
    K = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    toks = rng.integers(0, cfg.vocab, (B, S + 1, *K), dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    out = {"tokens": toks[:, :-1], "labels": labels}
    if cfg.n_patches:
        out["patch_emb"] = (0.02 * rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model))).astype(np.float32)
    return out


def _t(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _port_value_and_grad(params, cfg, batch):
    leaves = {k: v.detach().requires_grad_() for k, v in
              flatten_tree(params).items()}
    loss = transformer.train_loss(unflatten_tree(leaves), cfg, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                materialize_grads=True)
    return loss, dict(zip(leaves, grads))


# -- rmsnorm's backward -------------------------------------------------------

def test_rmsnorm_backward_matches_jax_grad_in_f32():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    scale = (rng.standard_normal(64) * 0.1).astype(np.float32)
    dy = rng.standard_normal((2, 5, 64)).astype(np.float32)
    want = jax.grad(lambda a, s: jnp.sum(jcommon.rmsnorm(a, s, 1e-5) * dy),
                    argnums=(0, 1))(x, scale)
    tx = torch.tensor(x, requires_grad=True)
    ts = torch.tensor(scale, requires_grad=True)
    got = torch.autograd.grad((common.rmsnorm(tx, ts) * torch.tensor(dy))
                              .sum(), (tx, ts))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # the formula is the function's derivative: the same as autograd of
    # the forward written out
    x32 = tx.detach().clone().requires_grad_()
    s32 = ts.detach().clone().requires_grad_()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + 1e-5) \
        * (1 + s32)
    auto = torch.autograd.grad((y * torch.tensor(dy)).sum(), (x32, s32))
    for g, a in zip(got, auto):
        torch.testing.assert_close(g, a, rtol=1e-5, atol=1e-5)


def test_rmsnorm_backward_matches_reference_vjp_in_bf16():
    """x and dy in bf16, scale in f32: dx comes back in bf16 and dscale in
    f32, each the reference's custom VJP's value (one bf16 rounding of an
    f32 result)."""
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((3, 7, 128)) * 2, jnp.bfloat16)
    scale = jnp.asarray(rng.standard_normal(128) * 0.1, jnp.float32)
    dy = jnp.asarray(rng.standard_normal((3, 7, 128)), jnp.bfloat16)
    y, vjp = jax.vjp(lambda a, s: jcommon.rmsnorm(a, s, 1e-5), x, scale)
    dx, ds = vjp(dy)

    def bf(a):
        return torch.from_numpy(np.asarray(a).view(np.uint16).copy()) \
            .view(torch.bfloat16)
    tx = bf(x).requires_grad_()
    ts = torch.tensor(np.asarray(scale), requires_grad=True)
    out = common.rmsnorm(tx, ts)
    gx, gs = torch.autograd.grad(out, (tx, ts), bf(dy))
    assert out.dtype == gx.dtype == torch.bfloat16
    assert gs.dtype == torch.float32
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(y, np.float32))
    np.testing.assert_allclose(gx.float().numpy(), np.asarray(dx, np.float32),
                               rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ds), rtol=1e-5,
                               atol=1e-5)


# -- the training loss and its gradients --------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loss_and_gradients_match_reference(arch):
    jcfg, cfg = _cfgs(arch)
    jparams = _np_params(jcfg)
    if arch == "deepseek-v3-671b":        # a live router_bias
        rb = jparams["moe_blocks"]["moe"]["router_bias"]
        jparams["moe_blocks"]["moe"]["router_bias"] = (0.01 * np.random
            .default_rng(2).standard_normal(rb.shape)).astype(np.float32)
    batch = _batch(cfg, 2, 40, 3)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.train_loss(p, jcfg, b)))(jparams, batch)
    loss, grads = _port_value_and_grad(lm_from_jax(jparams, device="cpu"),
                                       cfg, _t(batch))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    jflat = flatten_tree(_t(jgrads))
    assert list(jflat) == list(grads)
    assert len(jflat) == len(jax.tree.leaves(jgrads))
    top = max(float(g.abs().max()) for g in jflat.values())
    for name, g in grads.items():
        want = jflat[name].numpy()
        if name.endswith(ZERO_GRAD) and cfg.pos_emb != "rope":
            assert max(float(g.abs().max()), float(np.abs(want).max())) \
                <= ZERO_ATOL * top, name
            continue
        np.testing.assert_allclose(
            g.numpy(), want, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * float(np.abs(want).max()), err_msg=name)


@pytest.mark.parametrize("T,K", [(37, 0), (45, 4)])
def test_chunked_xent_pads_to_the_chunk_like_reference(T, K):
    """A T the chunk does not divide, -1 labels masked, vocab padding
    masked (vocab 300 in a head of 512); with K codebooks the labels are
    (T, K) and the logits (T, K, V)."""
    jcfg = dataclasses.replace(jget_config("musicgen-medium").reduced(),
                               vocab=300, n_codebooks=K)
    cfg = dataclasses.replace(get_config("musicgen-medium").reduced(),
                              vocab=300, n_codebooks=K)
    rng = np.random.default_rng(4)
    Kd = (K,) if K else ()
    head = (rng.standard_normal((*Kd, cfg.d_model, cfg.vocab_padded))
            * 0.05).astype(np.float32)
    h = rng.standard_normal((T, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (T, *Kd), dtype=np.int32)
    labels[::5] = -1
    want, (gh, ghead) = jax.value_and_grad(
        lambda hh, w: jtransformer.chunked_xent({"lm_head": w}, jcfg, hh,
                                                labels, chunk=16),
        argnums=(0, 1))(h, head)
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(head, requires_grad=True)
    got = transformer.chunked_xent({"lm_head": tw}, cfg, th,
                                   torch.tensor(labels), chunk=16)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    for g, w in zip(torch.autograd.grad(got, (th, tw)), (gh, ghead)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * float(np.abs(w).max()))
    with torch.no_grad():
        assert transformer.chunked_xent({"lm_head": tw}, cfg, th,
                                        torch.tensor(labels),
                                        chunk=16).item() == got.item()


# -- data and optimizers ------------------------------------------------------

@pytest.mark.parametrize("codebooks", [0, 4])
def test_fed_lm_batches_equal_reference(codebooks):
    kw = dict(vocab=500, n_clients=3, local_epochs=2, batch=2, seq=17,
              codebooks=codebooks)
    got = fed_lm_batches(np.random.default_rng(5), **kw)
    want = jfed_lm_batches(np.random.default_rng(5), **kw)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def _tree(rng, dtype=np.float32):
    return {"a": rng.standard_normal((3, 4)).astype(dtype),
            "b": {"c": rng.standard_normal(5).astype(dtype)}}


def _close_tree(got, want, **tol):
    for g, w in zip(jax.tree.leaves(lm_to_numpy(got)),
                    jax.tree.leaves(jax.tree.map(np.asarray, want)),
                    strict=True):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), **tol)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_step_matches_reference(momentum):
    rng = np.random.default_rng(6)
    p, g, m = _tree(rng), _tree(rng), _tree(rng)
    want = jsgd_step(p, g, 0.1, m if momentum else None, momentum)
    got = sgd_step(_t(p), _t(g), 0.1, _t(m) if momentum else None, momentum)
    _close_tree(got[0], want[0], rtol=1e-6, atol=1e-7)
    if momentum:
        _close_tree(got[1], want[1], rtol=1e-6, atol=1e-7)
    else:
        assert got[1] is None


def test_adamw_steps_match_reference():
    rng = np.random.default_rng(7)
    p = _tree(rng)
    jstate, state = jadamw_init(p), adamw_init(_t(p))
    jp, tp = p, _t(p)
    for step in range(3):
        g = _tree(rng)
        jp, jstate = jadamw_step(jp, g, jstate, 1e-2)
        tp, state = adamw_step(tp, _t(g), state, 1e-2)
    assert int(state["t"]) == int(jstate["t"]) == 3
    _close_tree(tp, jp, rtol=1e-6, atol=1e-7)
    _close_tree(state["m"], jstate["m"], rtol=1e-6, atol=1e-7)
    _close_tree(state["v"], jstate["v"], rtol=1e-6, atol=1e-9)
    for tau in (0, 1, 3, 10):
        assert staircase_lr(0.05, tau).dtype == torch.float32
        assert staircase_lr(0.05, tau).item() == float(jstaircase_lr(0.05,
                                                                     tau))
    assert staircase_lr(0.05, 5, 3).item() == float(jstaircase_lr(0.05, 5, 3))


# -- the federated LM round ---------------------------------------------------

def test_flatten_tree_keeps_jax_leaf_order():
    jcfg, cfg = _cfgs("deepseek-v3-671b")
    jparams = _np_params(jcfg)
    flat = flatten_tree(lm_from_jax(jparams, device="cpu"))
    assert sorted(flat) == list(flat)
    for (path, _), (name, leaf) in zip(
            jax.tree_util.tree_flatten_with_path(jparams)[0], flat.items(),
            strict=True):
        assert "/".join(k.key for k in path) == name
    back = unflatten_tree(flat)
    assert jax.tree.structure(lm_to_numpy(back)) == \
        jax.tree.structure(jparams)
    with pytest.raises(ValueError, match="sorts before"):
        flatten_tree({"a": {"x": torch.zeros(1)}, "a.b": torch.zeros(1)})


@pytest.mark.parametrize("arch", ["mamba2-130m", "llava-next-34b"])
def test_fed_round_matches_reference(arch):
    """One client-parallel round (agg="tree", the reference driver's) of
    4 clients x 2 local steps from the same params, alpha, coefficients
    and batches: every leaf's new params, and delta_norm."""
    jcfg, cfg = _cfgs(arch)
    jparams = _np_params(jcfg)
    C, E, B, S = 4, 2, 2, 24
    rng = np.random.default_rng(8)
    batch = train_mod.round_batches(rng, cfg, 0, n_clients=C, local_epochs=E,
                                    batch=B, seq=S)
    alpha = np.array([[1, 1], [1, 0], [0, 0], [1, 1]], np.float32)
    coeffs = np.array([0.25, 0.5, 0.0, 0.25], np.float32)
    eta = 0.05
    jround = jax.jit(jmake_fed_round(
        lambda p, b: jtransformer.train_loss(p, jcfg, b), "client_parallel"))
    jnew, jm = jround(jparams, batch, alpha, coeffs, jnp.float32(eta))
    params = lm_from_jax(jparams, device="cpu")
    round_fn = make_fed_round(per_client_loss(
        lambda p, b: transformer.train_loss(p, cfg, b)), "client_parallel")
    before = dict(ops.launches)
    _, m = round_fn(flatten_tree(params), _t(batch), torch.tensor(alpha),
                    torch.tensor(coeffs), torch.tensor(eta),
                    with_metrics=True)
    assert ops.launches == before
    # (FLIP_SHARE): elements an ulp apart at each of the E + 1 roundings
    # of the parameter are set aside where they are few
    jflat = flatten_tree(_t(jnew))
    start = flatten_tree(_t(jparams))
    for name, p in flatten_tree(params).items():
        want = jflat[name]
        diff = p - want
        top = torch.maximum(p.abs(), want.abs())
        flips = (diff != 0) & (diff.abs() <= (E + 1) * (
            torch.nextafter(top, torch.tensor(float("inf"))) - top))
        share = flips.float().mean().item()
        if share <= FLIP_SHARE:
            diff = diff.masked_fill(flips, 0.0)
        norm = (want - start[name]).norm().item()
        assert diff.norm().item() <= DELTA_TOL * norm, \
            (name, diff.norm().item(), norm, share)
    np.testing.assert_allclose(float(m["delta_norm"]), float(jm["delta_norm"]),
                               rtol=1e-5)


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    out = train_mod.main(["--device", "cpu", "--rounds", "2",
                          "--ckpt", str(tmp_path / "ck")])
    text = capsys.readouterr().out
    assert "arch=mamba2-130m" in text and "round   1" in text
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert all(d > 0 for d in out["delta_norms"])
    loaded, manifest = load_checkpoint(str(tmp_path / "ck"))
    assert manifest["step"] == 2
    assert manifest["extra"] == {"arch": "mamba2-130m", "scheme": "C"}
    for a, b in zip(jax.tree.leaves(lm_to_numpy(out["params"])),
                    jax.tree.leaves(loaded), strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_train_cli_vlm_draws_the_reference_patches(capsys):
    out = train_mod.main(["--device", "cpu", "--rounds", "1", "--arch",
                          "llava-next-34b", "--seq", "16"])
    assert np.isfinite(out["losses"]).all()
    cfg = get_config("llava-next-34b").reduced()
    got = train_mod.round_batches(np.random.default_rng(0), cfg, 3,
                                  n_clients=2, local_epochs=2, batch=2,
                                  seq=8)["patch_emb"]
    want = 0.02 * np.random.default_rng(3).normal(
        size=(2, 2, 2, cfg.n_patches, cfg.d_model)).astype(np.float32)
    np.testing.assert_array_equal(got, want)


# -- the forward-only kernels under grad --------------------------------------

def test_forward_only_wrappers_raise_under_grad():
    q = torch.randn(1, 2, 8, 32, requires_grad=True)
    k, v = torch.randn(1, 2, 8, 32), torch.randn(1, 2, 8, 32)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.flash_attention(q, k, v)
    cum = -torch.rand(3, 16).cumsum(-1)
    C, B = torch.randn(3, 16, 4, requires_grad=True), torch.randn(3, 16, 4)
    xdt = torch.randn(3, 16, 8)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.ssd_intra_chunk(cum, C, B, xdt)
    # without grad (no_grad, or no input requiring it) they run
    with torch.no_grad():
        ops.flash_attention(q, k, v)
        ops.ssd_intra_chunk(cum, C, B, xdt)
    ops.flash_attention(q.detach(), k, v)
    # the kernel's plain version, the mixer's term under grad, takes a
    # finite gradient where exp overflows above the diagonal, and its
    # values there are the masked zeros
    big = torch.linspace(0, -200, 16).expand(3, 16).contiguous()
    C2 = C.detach().clone().requires_grad_()
    y = ssd_intra_chunk_plain(big, C2, B, xdt)
    assert torch.isfinite(y).all()
    (g,) = torch.autograd.grad(y.sum(), C2)
    assert torch.isfinite(g).all()


def test_training_takes_the_differentiable_paths():
    """Under grad the SSD mixer computes its intra-chunk term with
    ssd_intra_chunk_plain, never the kernel's wrapper; a flash config's
    training loss raises instead of losing its attention's gradient."""
    from unittest import mock
    _, cfg = _cfgs("mamba2-130m")
    params = flatten_tree(lm_from_jax(_np_params(_cfgs("mamba2-130m")[0]),
                                      device="cpu"))
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    batch = _t(_batch(cfg, 1, 20, 9))
    with mock.patch.object(ops, "ssd_intra_chunk",
                           side_effect=AssertionError("kernel under grad")):
        loss = transformer.train_loss(unflatten_tree(leaves), cfg, batch)
        torch.autograd.grad(loss, list(leaves.values()))
    _, fcfg = _cfgs("nemotron-4-15b")
    fcfg = dataclasses.replace(fcfg, attn_impl="flash")
    fp = {k: v.requires_grad_() for k, v in flatten_tree(lm_from_jax(
        _np_params(_cfgs("nemotron-4-15b")[0]), device="cpu")).items()}
    with pytest.raises(RuntimeError, match="forward-only"):
        transformer.train_loss(unflatten_tree(fp), fcfg,
                               _t(_batch(fcfg, 1, 20, 9)))
    with torch.no_grad():
        assert torch.isfinite(transformer.train_loss(
            unflatten_tree(fp), fcfg, _t(_batch(fcfg, 1, 20, 9))))
