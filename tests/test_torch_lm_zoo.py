"""The port's LM zoo beyond nemotron and mamba2 (``repro_torch.models``
``mla``, ``moe``, the hybrid and MoE blocks, their caches and params)
against the reference at each architecture's ``reduced()`` config, in f32,
on the same numpy inputs and, through ``repro_torch.params.lm_from_jax``,
the reference's own weights.  Tolerances are ``test_torch_lm.py``'s: f32
in another summation order for the building blocks (BLOCK_TOL), and for
whole models the chunked path's SLICE_TOL (the flash path's where the
flash kernel's plain version runs)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import blocks as jblocks
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.models.params import init_params as jinit_params
from repro_torch.configs import ARCH_IDS, PORTED_IDS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.models import mla, moe, transformer
from repro_torch.models.blocks import block_apply
from repro_torch.models.params import init_params, param_count
from repro_torch.params import lm_from_jax, lm_to_numpy

KEY = jax.random.PRNGKey(0)
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
SLICE_TOL = {"chunked": dict(rtol=1e-4, atol=1e-4),
             "flash": dict(rtol=1e-3, atol=1e-3)}
NEW_ARCHS = ["starcoder2-3b", "gemma-7b", "command-r-plus-104b",
             "hymba-1.5b", "deepseek-v2-lite-16b", "deepseek-v3-671b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the whole-model cases run a few hundred small ops each; more intra-op
    # threads than a CPU test run's share of cores only slow them
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **changes):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **changes)
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    return jcfg, cfg


def _np_params(jcfg, key=KEY):
    return jax.tree.map(np.asarray, jinit_params(key, jcfg))


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), **tol)


def _layer0(tree):
    return jax.tree.map(lambda a: np.asarray(a[0]), tree)


def _zeros_like_cache(jcache):
    """The port's copy of a reference cache (numpy -> torch, writable)."""
    return {k: _t(v).clone() for k, v in jcache.items()}


# -- MLA ------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v3-671b"])
def test_mla_prefill_and_decode_match_reference(arch):
    """The decompressed prefill and the absorbed decode, q_lora_rank 0
    (v2-lite) and 64 (v3's reduced), the compressed cache included."""
    jcfg, cfg = _cfgs(arch)
    assert bool(cfg.q_lora_rank) == (arch == "deepseek-v3-671b")
    p = _layer0(_np_params(jcfg)["moe_blocks"]["attn"])
    if cfg.q_lora_rank:
        assert "w_dq" in p and "wq" not in p
    rng = np.random.default_rng(11)
    # non-zero norm scales, so that q_ln and kv_ln are exercised
    for name in ("q_ln", "kv_ln"):
        if name in p:
            p[name] = {"scale": (rng.standard_normal(
                p[name]["scale"].shape) * 0.1).astype(np.float32)}
    tp = jax.tree.map(_t, p)
    B, S, slots = 2, 16, 20
    jcache = {"ckv": jnp.zeros((B, slots, cfg.kv_lora_rank)),
              "krope": jnp.zeros((B, slots, cfg.qk_rope_dim)),
              "pos_map": jnp.full((slots,), -1, jnp.int32)}
    cache = _zeros_like_cache(jcache)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    want, jcache = jmla.mla_attention(p, x, jcfg, pos, cache=jcache)
    got, cache = mla.mla_attention(tp, _t(x), cfg, _t(pos).long(),
                                   cache=cache)
    assert got.shape == (B, S, cfg.d_model)
    _close(got, want, **BLOCK_TOL)
    for name in ("ckv", "krope", "pos_map"):
        _close(cache[name], jcache[name], **BLOCK_TOL)
    for t in range(S, S + 3):       # the absorbed path, slot by slot
        x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, jcache = jmla.mla_attention(p, x1, jcfg,
                                          np.array([t], np.int32),
                                          cache=jcache, decode=True)
        got, cache = mla.mla_attention(tp, _t(x1), cfg, torch.tensor([t]),
                                       cache=cache, decode=True)
        _close(got, want, **BLOCK_TOL)
    for name in ("ckv", "krope", "pos_map"):
        _close(cache[name], jcache[name], **BLOCK_TOL)
    assert int(cache["pos_map"][S + 2]) == S + 2
    assert int(cache["pos_map"][S + 3]) == -1
    # without a cache the prefill writes nothing and returns None
    got, none = mla.mla_attention(tp, _t(x), cfg, _t(pos).long())
    assert none is None


def test_mla_absorbed_decode_equals_the_decompressed_prefill():
    """The absorbed decode of position t against the decompressed prefill's
    row t, in the port alone: the two paths compute one function."""
    _, cfg = _cfgs("deepseek-v2-lite-16b")
    p = jax.tree.map(_t, _layer0(_np_params(_cfgs(
        "deepseek-v2-lite-16b")[0])["moe_blocks"]["attn"]))
    rng = np.random.default_rng(12)
    B, S = 2, 12
    x = _t(rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    full, _ = mla.mla_attention(p, x, cfg, torch.arange(S))
    cache = {"ckv": torch.zeros(B, S, cfg.kv_lora_rank),
             "krope": torch.zeros(B, S, cfg.qk_rope_dim),
             "pos_map": torch.full((S,), -1, dtype=torch.int32)}
    mla.mla_attention(p, x[:, :S - 2], cfg, torch.arange(S - 2), cache=cache)
    for t in (S - 2, S - 1):
        got, cache = mla.mla_attention(p, x[:, t:t + 1], cfg,
                                       torch.tensor([t]), cache=cache,
                                       decode=True)
        torch.testing.assert_close(got[:, 0], full[:, t], **BLOCK_TOL)


# -- MoE ------------------------------------------------------------------------

def _moe_case(arch, capacity_factor=None, seed=13, T=24):
    changes = {} if capacity_factor is None else \
        dict(capacity_factor=capacity_factor)
    jcfg, cfg = _cfgs(arch, **changes)
    p = _layer0(_np_params(jcfg)["moe_blocks"]["moe"])
    rng = np.random.default_rng(seed)
    if "router_bias" in p:          # a live bias, so that it steers selection
        p["router_bias"] = (rng.standard_normal(p["router_bias"].shape)
                            * 0.01).astype(np.float32)
    x = rng.standard_normal((2, T // 2, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, p, x


@pytest.mark.parametrize("arch,capacity_factor", [
    ("deepseek-v2-lite-16b", None),      # softmax router, shared expert
    ("deepseek-v3-671b", None),          # sigmoid router with router_bias
    ("deepseek-v2-lite-16b", 0.25),      # entries overflow cap
    ("deepseek-v3-671b", 0.25),
])
def test_moe_ffn_matches_reference(arch, capacity_factor):
    jcfg, cfg, p, x = _moe_case(arch, capacity_factor)
    want, jaux = jmoe.moe_ffn(p, x, jcfg)
    got, aux = moe.moe_ffn(jax.tree.map(_t, p), _t(x), cfg)
    _close(got, want, **BLOCK_TOL)
    _close(aux, jaux, **BLOCK_TOL)
    # the selected experts, gates and per-expert ranks are the reference's
    xf = x.reshape(-1, cfg.d_model)
    j_top, j_gates, j_aux = jmoe._routing(xf, p, jcfg)
    top, gates, aux2 = moe._routing(_t(xf), jax.tree.map(_t, p), cfg)
    np.testing.assert_array_equal(top.numpy(), np.asarray(j_top))
    _close(gates, j_gates, **BLOCK_TOL)
    _close(aux2, j_aux, **BLOCK_TOL)
    T, k, E = xf.shape[0], cfg.top_k, cfg.n_experts
    cap = moe._capacity(T, k, E, cfg.capacity_factor)
    assert cap == jmoe._capacity(T, k, E, jcfg.capacity_factor)
    fe = np.asarray(j_top).reshape(-1)
    oh = np.eye(E, dtype=np.int64)[fe]
    rank = (np.cumsum(oh, 0) - oh)[np.arange(T * k), fe]
    if capacity_factor is not None:
        assert int((rank >= cap).sum()) > 0, \
            "the case must drop entries past cap"


def test_moe_top_k_breaks_ties_as_lax_top_k():
    """Equal scores: the lower expert index first, as ``lax.top_k`` orders
    them (``torch.topk`` does not promise it)."""
    rng = np.random.default_rng(14)
    sel = np.round(rng.standard_normal((64, 8)), 1).astype(np.float32)
    sel[:, 5] = sel[:, 2]            # a tie in every row
    sel[:, 7] = sel[:, 2]
    for k in (1, 2, 3, 6):
        _, want = jax.lax.top_k(jnp.asarray(sel), k)
        got = moe._top_k(torch.tensor(sel), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_moe_routing_with_tied_router_columns_matches_reference():
    """Two experts with one router column score alike for every token: the
    dispatch (which of the two each token takes, hence every rank) must be
    the reference's."""
    jcfg, cfg, p, x = _moe_case("deepseek-v2-lite-16b")
    p["router"] = np.array(p["router"])
    p["router"][:, 3] = p["router"][:, 1]
    want, jaux = jmoe.moe_ffn(p, x, jcfg)
    got, aux = moe.moe_ffn(jax.tree.map(_t, p), _t(x), cfg)
    xf = x.reshape(-1, cfg.d_model)
    np.testing.assert_array_equal(
        moe._routing(_t(xf), jax.tree.map(_t, p), cfg)[0].numpy(),
        np.asarray(jmoe._routing(xf, p, jcfg)[0]))
    _close(got, want, **BLOCK_TOL)
    _close(aux, jaux, **BLOCK_TOL)


# -- the hybrid block -----------------------------------------------------------

def test_hybrid_block_prefill_and_decode_match_reference():
    """Hymba's block: attention (sliding window, ring buffer) and SSM on
    the same normed input, each through its own rmsnorm, averaged, then
    the MLP; the prefill through the window, then decode steps that wrap
    the ring buffer, both caches included."""
    jcfg, cfg = _cfgs("hymba-1.5b")
    p = _layer0(_np_params(jcfg)["blocks"])
    rng = np.random.default_rng(15)
    for name in ("ln_a", "ln_s", "ln1", "ln2"):   # live norm scales
        p[name] = {"scale": (rng.standard_normal(cfg.d_model)
                             * 0.1).astype(np.float32)}
    tp = jax.tree.map(_t, p)
    W = cfg.sliding_window
    B, S = 2, W + 32                     # past the window
    jc = jax.tree.map(lambda a: a[0],
                      jtransformer.init_cache(jcfg, B, S + 8)["blocks"])
    cache = jax.tree.map(lambda a: _t(a).clone(), jc)
    assert cache["attn"]["k"].shape[1] == W
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    want, jaux, jc = jblocks.block_apply(p, x, jcfg, "hybrid", pos, cache=jc)
    got, aux, cache = block_apply(tp, _t(x), cfg, "hybrid", _t(pos).long(),
                                  cache=cache)
    _close(got, want, **BLOCK_TOL)
    assert aux == 0.0 and float(jaux) == 0.0
    for t in range(S, S + 8):
        x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, _, jc = jblocks.block_apply(p, x1, jcfg, "hybrid",
                                          np.array([t], np.int32), cache=jc,
                                          decode=True)
        got, _, cache = block_apply(tp, _t(x1), cfg, "hybrid",
                                    torch.tensor([t]), cache=cache,
                                    decode=True)
        _close(got, want, **BLOCK_TOL)
    for branch in ("attn", "ssm"):
        for name, leaf in cache[branch].items():
            _close(leaf, jc[branch][name], **BLOCK_TOL)


# -- whole models ---------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill, then teacher-forced decode steps, with the reference's
    weights, each step's logits against the reference's; the prompt and
    the steps go past the reduced config's sliding window (64) where there
    is one."""
    jcfg, cfg = _cfgs(arch)
    jparams = _np_params(jcfg)
    params = lm_from_jax(jparams, device="cpu")
    B, Sp, n_dec = 2, 72, 4
    S = Sp + n_dec
    tokens = np.random.default_rng(16).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)
    tt = torch.tensor(tokens).long()
    jcache = jtransformer.init_cache(jcfg, B, S)
    cache = transformer.init_cache(cfg, B, S, device="cpu")
    assert jax.tree.structure(jax.tree.map(np.asarray, jcache)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), cache))
    before = dict(ops.launches)
    want, jcache = jtransformer.prefill(jparams, jcfg, tokens[:, :Sp], jcache)
    got, cache = transformer.prefill(params, cfg, tt[:, :Sp], cache)
    assert got.dtype == torch.float32 and got.shape == (B, 1, cfg.vocab)
    _close(got, want, **SLICE_TOL["chunked"])
    for t in range(Sp, S):
        want, jcache = jtransformer.decode_step(
            jparams, jcfg, jcache, tokens[:, t:t + 1], jnp.int32(t))
        got, cache = transformer.decode_step(params, cfg, cache,
                                             tt[:, t:t + 1], t)
        _close(got, want, **SLICE_TOL["chunked"])
    jleaves = jax.tree.leaves(jax.tree.map(np.asarray, jcache))
    for a, b in zip(jleaves, jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), cache)), strict=True):
        _close(torch.tensor(b), a, **SLICE_TOL["chunked"])
    assert ops.launches == before          # the CPU takes the plain versions


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v3-671b"])
def test_model_forward_sums_the_stacks_aux_losses(arch):
    """model_forward over the dense and the MoE stacks: the hidden states
    and the summed router aux loss against the reference's."""
    jcfg, cfg = _cfgs(arch)
    jparams = _np_params(jcfg)
    tokens = np.random.default_rng(17).integers(0, cfg.vocab, (2, 24),
                                                dtype=np.int32)
    jh, jaux, _ = jtransformer.model_forward(jparams, jcfg, tokens)
    h, aux, _ = transformer.model_forward(lm_from_jax(jparams, device="cpu"),
                                          cfg, torch.tensor(tokens).long())
    _close(h, jh, **SLICE_TOL["chunked"])
    assert float(jaux) > 0.0
    _close(aux, jaux, **BLOCK_TOL)


def test_gemma_head_dim_256_with_flash_matches_reference():
    """gemma's reduced config at its real head dim of 256 with
    attn_impl="flash": the reference's Pallas kernel (interpret mode)
    against the port's flash_attention (its plain version on the CPU)."""
    jcfg, cfg = _cfgs("gemma-7b", head_dim=256, attn_impl="flash")
    jparams = _np_params(jcfg)
    params = lm_from_jax(jparams, device="cpu")
    B, S = 2, 40
    Sp = S - 3
    tokens = np.random.default_rng(18).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)
    tt = torch.tensor(tokens).long()
    jcache = jtransformer.init_cache(jcfg, B, S)
    cache = transformer.init_cache(cfg, B, S, device="cpu")
    want, jcache = jtransformer.prefill(jparams, jcfg, tokens[:, :Sp], jcache)
    got, cache = transformer.prefill(params, cfg, tt[:, :Sp], cache)
    _close(got, want, **SLICE_TOL["flash"])
    for t in range(Sp, S):
        want, jcache = jtransformer.decode_step(
            jparams, jcfg, jcache, tokens[:, t:t + 1], jnp.int32(t))
        got, cache = transformer.decode_step(params, cfg, cache,
                                             tt[:, t:t + 1], t)
        _close(got, want, **SLICE_TOL["flash"])


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_decode_matches_own_full_forward(arch):
    """The cached path against the port's own full forward, past the
    window; weights from the port's own init."""
    _, cfg = _cfgs(arch)
    params = init_params(cfg, seed=1, device="cpu")
    B, S = 2, 80
    tokens = torch.tensor(np.random.default_rng(19).integers(
        0, cfg.vocab, (B, S))).long()
    h, _, _ = transformer.model_forward(params, cfg, tokens)
    full = transformer.logits_fn(params, cfg, h)[..., :cfg.vocab]
    Sp = S - 4
    cache = transformer.init_cache(cfg, B, S, device="cpu")
    lg, cache = transformer.prefill(params, cfg, tokens[:, :Sp], cache)
    torch.testing.assert_close(lg[:, 0], full[:, Sp - 1], rtol=1e-4,
                               atol=1e-4)
    for t in range(Sp, S):
        lg, cache = transformer.decode_step(params, cfg, cache,
                                            tokens[:, t:t + 1], t)
        torch.testing.assert_close(lg[:, 0], full[:, t], rtol=1e-4,
                                   atol=1e-4)


# -- the converter and the parameter trees --------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_converter_round_trip_and_own_init_tree(arch):
    """The reference's tree (hybrid, MLA with and without q_lora, MoE with
    router_bias and shared experts, the MTP subtree) through
    lm_from_jax/lm_to_numpy unchanged; the port's own init has its keys,
    shapes and dtypes; bf16 bit for bit."""
    jcfg, cfg = _cfgs(arch)
    jparams = _np_params(jcfg)
    params = lm_from_jax(jparams, device="cpu")
    back = lm_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    mine = lm_to_numpy(init_params(cfg, seed=0, device="cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(mine)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    assert param_count(params) == sum(a.size for a in jax.tree.leaves(jparams))
    jbf = _np_params(dataclasses.replace(jcfg, dtype="bfloat16"))
    bf = lm_from_jax(jbf, device="cpu")
    for a, b in zip(jax.tree.leaves(jbf), jax.tree.leaves(
            jax.tree.map(lambda t: t, bf))):
        if a.dtype.name == "bfloat16":
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(b.numpy(), a)
    expect = {"hymba-1.5b": ("blocks", "ln_a"),
              "deepseek-v2-lite-16b": ("moe_blocks", "moe"),
              "deepseek-v3-671b": ("mtp", "mtp_proj")}
    if arch in expect:
        outer, inner = expect[arch]
        assert inner in params[outer]


# -- configs and the serving entry point ----------------------------------------

def test_every_ported_id_serves_at_its_reduced_config():
    assert PORTED_IDS == ARCH_IDS and set(NEW_ARCHS) < set(PORTED_IDS)
    for arch in NEW_ARCHS:
        cfg = get_config(arch).reduced()
        out = serve_mod.serve(cfg, batch=1, prompt_len=8, gen=1, seed=0,
                              device="cpu")
        assert out["tokens"].shape == (1, 1)
        assert torch.isfinite(out["logits"]).all()


@pytest.mark.parametrize("arch", ["hymba-1.5b", "deepseek-v2-lite-16b"])
def test_serve_cli_runs_on_the_cpu(arch, capsys):
    serve_mod.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                    "--prompt-len", "8", "--gen", "2"])
    out = capsys.readouterr().out
    assert f"serving {arch}" in out and "decode: 4 tokens" in out


def test_serve_cli_help_lists_every_ported_id(capsys):
    with pytest.raises(SystemExit):
        serve_mod.main(["--help"])
    out = " ".join(capsys.readouterr().out.split())
    for arch in PORTED_IDS:
        assert arch in out


@pytest.mark.parametrize("E,n,seed", [(4, 48, 0), (64, 600, 1), (8, 1, 2)])
def test_rank_in_expert_is_the_exclusive_cumsum_of_the_one_hot(E, n, seed):
    """The dispatch's per-expert rank against the reference's formula,
    (cumsum(oh) - oh)[i, fe[i]] in token-major order, skewed choices and
    experts nobody chose included."""
    rng = np.random.default_rng(seed)
    fe = rng.choice(E, size=n, p=np.r_[[0.5], np.full(E - 1, 0.5 / (E - 1))])
    oh = np.eye(E, dtype=np.int64)[fe]
    want = (np.cumsum(oh, 0) - oh)[np.arange(n), fe]
    got = moe._rank_in_expert(torch.tensor(fe), E)
    np.testing.assert_array_equal(got.numpy(), want)
