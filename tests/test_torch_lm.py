"""The port's LM serving path (``repro_torch.models``, ``launch/serve``)
against the reference at ``get_config("nemotron-4-15b").reduced()``, on
the same numpy inputs and, through ``repro_torch.params.lm_from_jax``, the
reference's own weights.  Tolerances: the reference's for the serving path
(``tests/test_decode.py:32-41`` and ``:119-121``), and for the building
blocks f32 values in another summation order."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattention
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import rotary as jrotary
from repro.models import transformer as jtransformer
from repro.models.params import init_params as jinit_params
from repro_torch.configs import PORTED_IDS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.models import attention, common, rotary, transformer
from repro_torch.models.blocks import block_apply
from repro_torch.models.params import init_params, param_count
from repro_torch.params import lm_from_jax, lm_to_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside the other test workers, a pool of
    threads per process oversubscribes the cores, and its idle threads
    spin, slowing every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "nemotron-4-15b"
KEY = jax.random.PRNGKey(0)
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
SLICE_TOL = {"chunked": dict(rtol=1e-4, atol=1e-4),
             "flash": dict(rtol=1e-3, atol=1e-3)}


def _cfgs(attn_impl="chunked"):
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(),
                               attn_impl=attn_impl)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), attn_impl=attn_impl)
    return jcfg, cfg


def _np_params(jcfg, key=KEY):
    return jax.tree.map(np.asarray, jinit_params(key, jcfg))


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), **tol)


# -- configs ------------------------------------------------------------------

def _same_fields(cfg, jcfg):
    """The port's config against the reference's on every field, the
    nested FedConfig field by field, and on the derived properties."""
    assert [f.name for f in dataclasses.fields(cfg)] == \
        [f.name for f in dataclasses.fields(jcfg)]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for name in ("vocab_padded", "attn_free", "d_inner", "ssm_n_heads",
                 "moe_layers", "dense_layers"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert cfg.supports_shape(shape) == jcfg.supports_shape(shape)


@pytest.mark.parametrize("arch", PORTED_IDS)
def test_config_and_reduced_match_reference(arch):
    jcfg = jget_config(arch)
    _same_fields(get_config(arch), jcfg)
    _same_fields(get_config(arch).reduced(), jcfg.reduced())
    assert get_config(arch).attn_impl == "chunked"
    # every field keeps the reference's default
    default = type(jcfg)(name="", family="dense", n_layers=1, d_model=1,
                         vocab=1)
    mine = type(get_config(arch))(name="", family="dense", n_layers=1,
                                  d_model=1, vocab=1)
    assert dataclasses.asdict(mine) == dataclasses.asdict(default)


def test_registry_matches_reference():
    from repro.configs import base as jbase
    from repro_torch.configs import base
    assert base.ARCH_IDS == jbase.ARCH_IDS
    assert base.PAPER_IDS == jbase.PAPER_IDS
    assert {k: dataclasses.asdict(v) for k, v in base.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v)
            for k, v in jbase.INPUT_SHAPES.items()}
    assert dataclasses.asdict(base.FedConfig()) == \
        dataclasses.asdict(jbase.FedConfig())
    assert PORTED_IDS == base.ARCH_IDS
    mine = base.all_configs()
    assert list(mine) == PORTED_IDS
    for arch, cfg in mine.items():
        _same_fields(cfg, jget_config(arch))


def test_unknown_block_kind_raises():
    with pytest.raises(ValueError, match="unknown block kind"):
        block_apply({}, torch.zeros(1, 1, 8), get_config(ARCH).reduced(),
                    "vlm", torch.zeros(1))


# -- (b) building blocks ------------------------------------------------------

def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(256).astype(np.float32) * 0.1
    bias = rng.standard_normal(256).astype(np.float32) * 0.1
    _close(common.rmsnorm(_t(x), _t(scale)),
           jcommon.rmsnorm(x, scale, 1e-5), **BLOCK_TOL)
    _close(common.layernorm(_t(x), _t(scale), _t(bias)),
           jcommon.layernorm(x, scale, bias), **BLOCK_TOL)
    _close(common.layernorm(_t(x), _t(scale), None),
           jcommon.layernorm(x, scale, None), **BLOCK_TOL)
    jcfg, cfg = _cfgs()
    p = {"scale": scale, "bias": bias}
    _close(common.apply_norm(_t(x), {k: _t(v) for k, v in p.items()}, cfg),
           jcommon.apply_norm(x, p, jcfg), **BLOCK_TOL)


@pytest.mark.parametrize("name", ["silu", "gelu", "geglu", "sq_relu"])
def test_activations_match_reference(name):
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    _close(common.activation_fn(name)(_t(x)),
           jcommon.activation_fn(name)(x), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("gated", [False, True])
def test_mlp_matches_reference(gated):
    jcfg, cfg = _cfgs()
    if gated:
        jcfg = dataclasses.replace(jcfg, gated_mlp=True, activation="silu")
        cfg = dataclasses.replace(cfg, gated_mlp=True, activation="silu")
    rng = np.random.default_rng(1)
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_up": rng.standard_normal((d, f)) * 0.05,
         "w_down": rng.standard_normal((f, d)) * 0.05,
         "b_up": rng.standard_normal(f) * 0.1,
         "b_down": rng.standard_normal(d) * 0.1}
    if gated:
        p["w_gate"] = rng.standard_normal((d, f)) * 0.05
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    _close(common.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), cfg),
           jcommon.mlp_apply(p, x, jcfg), **BLOCK_TOL)


def test_rope_and_sinusoids_match_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    pos = np.arange(16, dtype=np.int32) + 4000
    _close(rotary.rope_freqs(32, 10000.0), jrotary.rope_freqs(32, 10000.0),
           rtol=1e-6, atol=0)
    _close(rotary.apply_rope(_t(x), _t(pos), 10000.0),
           jrotary.apply_rope(x, pos, 10000.0), **BLOCK_TOL)
    # split halves, not interleaved pairs: position 0 is the identity and
    # dims i and i + hd/2 rotate together
    _close(rotary.apply_rope(_t(x), torch.zeros(16), 10000.0), x,
           rtol=0, atol=0)
    _close(rotary.sinusoidal(_t(pos), 64), jrotary.sinusoidal(pos, 64),
           **BLOCK_TOL)


@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
def test_gqa_attention_prefill_and_decode_match_reference(attn_impl):
    jcfg, cfg = _cfgs(attn_impl)
    rng = np.random.default_rng(3)
    p = jax.tree.map(lambda a: np.asarray(a[0]),
                     _np_params(jcfg)["blocks"]["attn"])
    for name in ("bq", "bk", "bv", "bo"):     # exercise the biases
        p[name] = (rng.standard_normal(p[name].shape) * 0.1).astype(
            np.float32)
    tp = {k: _t(v) for k, v in p.items()}
    B, S, slots = 2, 16, 20
    width = cfg.n_kv_heads * cfg.head_dim
    jcache = {"k": jnp.zeros((B, slots, width)),
              "v": jnp.zeros((B, slots, width)),
              "pos_map": jnp.full((slots,), -1, jnp.int32)}
    cache = {"k": torch.zeros(B, slots, width),
             "v": torch.zeros(B, slots, width),
             "pos_map": torch.full((slots,), -1, dtype=torch.int32)}
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    want, jcache = jattention.gqa_attention(p, x, jcfg, pos, cache=jcache)
    got, cache = attention.gqa_attention(tp, _t(x), cfg, _t(pos).long(),
                                         cache=cache)
    _close(got, want, **BLOCK_TOL)
    for name in ("k", "v", "pos_map"):
        _close(cache[name], jcache[name], **BLOCK_TOL)
    # one decode step at position S writes slot S and reads S + 1 slots
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    pos1 = np.array([S], np.int32)
    want, jcache = jattention.gqa_attention(p, x1, jcfg, pos1, cache=jcache,
                                            decode=True)
    got, cache = attention.gqa_attention(tp, _t(x1), cfg, _t(pos1).long(),
                                         cache=cache, decode=True)
    _close(got, want, **BLOCK_TOL)
    for name in ("k", "v", "pos_map"):
        _close(cache[name], jcache[name], **BLOCK_TOL)
    assert int(cache["pos_map"][S]) == S and int(cache["pos_map"][S + 1]) == -1


def test_sliding_window_ring_buffer_matches_reference():
    """The window mask and the ring-buffer cache (fewer slots than
    positions) that sliding-window configs take."""
    jcfg, cfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, sliding_window=8)
    cfg = dataclasses.replace(cfg, sliding_window=8)
    rng = np.random.default_rng(6)
    p = jax.tree.map(lambda a: np.asarray(a[0]),
                     _np_params(jcfg)["blocks"]["attn"])
    tp = {k: _t(v) for k, v in p.items()}
    B, S, slots = 2, 24, 8
    width = cfg.n_kv_heads * cfg.head_dim
    jcache = {"k": jnp.zeros((B, slots, width)),
              "v": jnp.zeros((B, slots, width)),
              "pos_map": jnp.full((slots,), -1, jnp.int32)}
    cache = {"k": torch.zeros(B, slots, width),
             "v": torch.zeros(B, slots, width),
             "pos_map": torch.full((slots,), -1, dtype=torch.int32)}
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    want, jcache = jattention.gqa_attention(p, x, jcfg, pos, cache=jcache)
    got, cache = attention.gqa_attention(tp, _t(x), cfg, _t(pos).long(),
                                         cache=cache)
    _close(got, want, **BLOCK_TOL)
    for t in range(S, S + 10):      # wraps the 8 slots
        x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, jcache = jattention.gqa_attention(
            p, x1, jcfg, np.array([t], np.int32), cache=jcache, decode=True)
        got, cache = attention.gqa_attention(
            tp, _t(x1), cfg, torch.tensor([t]), cache=cache, decode=True)
        _close(got, want, **BLOCK_TOL)
    for name in ("k", "v", "pos_map"):
        _close(cache[name], jcache[name], **BLOCK_TOL)


@pytest.mark.parametrize("parallel_residual", [False, True])
def test_dense_block_matches_reference(parallel_residual):
    jcfg, cfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, parallel_residual=parallel_residual)
    cfg = dataclasses.replace(cfg, parallel_residual=parallel_residual)
    p = jax.tree.map(lambda a: np.asarray(a[0]), _np_params(jcfg)["blocks"])
    assert ("ln2" in p) != parallel_residual
    x = np.random.default_rng(7).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    pos = np.arange(16, dtype=np.int32)
    want, _, _ = jblocks.block_apply(p, x, jcfg, "dense", pos)
    got, aux, cache = block_apply(jax.tree.map(_t, p), _t(x), cfg, "dense",
                                  _t(pos).long())
    _close(got, want, **BLOCK_TOL)
    assert aux == 0.0 and cache is None


@pytest.mark.parametrize("embed_scale,pos_emb", [(False, "rope"),
                                                 (True, "sinusoidal")])
def test_embed_tokens_matches_reference(embed_scale, pos_emb):
    jcfg, cfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, embed_scale=embed_scale, pos_emb=pos_emb)
    cfg = dataclasses.replace(cfg, embed_scale=embed_scale, pos_emb=pos_emb)
    params = _np_params(jcfg)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab, (2, 9),
                                               dtype=np.int32)
    pos = np.arange(9, dtype=np.int32)
    want = jtransformer.embed_tokens(params, jcfg, tokens, pos)
    got = transformer.embed_tokens({"embed": _t(params["embed"])}, cfg,
                                   _t(tokens).long(), _t(pos).long())
    _close(got, want, **BLOCK_TOL)


# -- (c) the whole slice with the reference's weights -------------------------

@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
def test_prefill_and_decode_match_reference(attn_impl):
    jcfg, cfg = _cfgs(attn_impl)
    jparams = _np_params(jcfg)
    params = lm_from_jax(jparams, device="cpu")
    B, S = 2, 32
    Sp = S - 4
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    tt = torch.tensor(tokens).long()
    jcache = jtransformer.init_cache(jcfg, B, S)
    cache = transformer.init_cache(cfg, B, S, device="cpu")
    before = dict(ops.launches)
    want, jcache = jtransformer.prefill(jparams, jcfg, tokens[:, :Sp], jcache)
    got, cache = transformer.prefill(params, cfg, tt[:, :Sp], cache)
    assert got.dtype == torch.float32 and got.shape == (B, 1, cfg.vocab)
    _close(got, want, **SLICE_TOL[attn_impl])
    for t in range(Sp, S):
        want, jcache = jtransformer.decode_step(
            jparams, jcfg, jcache, tokens[:, t:t + 1], jnp.int32(t))
        got, cache = transformer.decode_step(params, cfg, cache,
                                             tt[:, t:t + 1], t)
        _close(got, want, **SLICE_TOL[attn_impl])
    assert ops.launches == before          # the CPU takes the plain versions


# -- (d) the converter --------------------------------------------------------

def test_converter_round_trip_is_exact():
    jcfg, cfg = _cfgs()
    jparams = _np_params(jcfg)
    params = lm_from_jax(jparams, device="cpu")
    back = lm_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the port's own init has the reference's tree, shapes and dtypes
    mine = lm_to_numpy(init_params(cfg, seed=0, device="cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(mine)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    assert param_count(params) == sum(a.size for a in jax.tree.leaves(jparams))


def test_converter_carries_bf16_bit_for_bit():
    jcfg, cfg = _cfgs()
    jparams = _np_params(dataclasses.replace(jcfg, dtype="bfloat16"))
    params = lm_from_jax(jparams, device="cpu")
    wq = params["blocks"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    assert params["final_norm"]["scale"].dtype == torch.float32
    np.testing.assert_array_equal(
        wq.view(torch.int16).numpy(),
        jparams["blocks"]["attn"]["wq"].view(np.int16))
    back = lm_to_numpy(params)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a.astype(np.float32), b)
    bf16 = init_params(dataclasses.replace(cfg, dtype="bfloat16"), seed=0,
                       device="cpu")
    assert bf16["embed"].dtype == torch.bfloat16
    assert bf16["blocks"]["ln1"]["scale"].dtype == torch.float32


# -- (e) prefill + decode against the port's own full forward -----------------

@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
def test_prefill_decode_matches_own_full_forward(attn_impl):
    _, cfg = _cfgs(attn_impl)
    params = init_params(cfg, seed=1, device="cpu")
    B, S = 2, 32
    tokens = torch.tensor(np.random.default_rng(5).integers(
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


# -- the serving entry point --------------------------------------------------

def test_serve_prefill_matches_reference_on_its_prompts():
    jcfg, cfg = _cfgs("flash")
    jparams = _np_params(jcfg)
    out = serve_mod.serve(cfg, batch=2, prompt_len=24, gen=3, seed=0,
                          device="cpu",
                          params=lm_from_jax(jparams, device="cpu"))
    assert out["tokens"].shape == (2, 3)
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab)).all())
    assert torch.isfinite(out["logits"]).all()
    prompts = out["prompts"].numpy().astype(np.int32)
    want, _ = jtransformer.prefill(jparams, jcfg, prompts,
                                   jtransformer.init_cache(jcfg, 2, 27))
    _close(out["prefill_logits"], want, **SLICE_TOL["flash"])


def test_serve_cli_runs_on_the_cpu(capsys):
    serve_mod.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                    "--gen", "2"])
    out = capsys.readouterr().out
    # the reference's default architecture
    assert "serving mamba2-130m" in out and "decode: 4 tokens" in out
