"""The port's multimodal and audio LMs for serving (llava-next-34b's patch
embeddings, musicgen-medium's K codebooks) against the reference at each
architecture's ``reduced()`` config, in f32, on the same numpy inputs and,
through ``repro_torch.params.lm_from_jax``, the reference's own weights;
and ``serve``'s default architecture against the reference CLI's.
Tolerances are ``test_torch_lm.py``'s: the chunked path's SLICE_TOL for
whole models, BLOCK_TOL for the building blocks."""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import fed_train as jfed_train
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import transformer as jtransformer
from repro.models.params import init_params as jinit_params
from repro_torch.configs import ARCH_IDS, PORTED_IDS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import fed_train as fed_train_mod
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import transformer
from repro_torch.models.params import init_params, param_count
from repro_torch.params import lm_from_jax, lm_to_numpy

KEY = jax.random.PRNGKey(0)
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
SLICE_TOL = dict(rtol=1e-4, atol=1e-4)
MODAL = ["llava-next-34b", "musicgen-medium"]


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


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), **tol)


def _tokens(cfg, shape, seed):
    K = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    return np.random.default_rng(seed).integers(0, cfg.vocab, (*shape, *K),
                                                dtype=np.int32)


# -- configs and params -------------------------------------------------------

def test_every_architecture_is_ported():
    assert PORTED_IDS == ARCH_IDS and len(PORTED_IDS) == 10
    for arch in MODAL:
        cfg = get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jget_config(arch))
    assert get_config("llava-next-34b").n_patches == 576
    assert get_config("musicgen-medium").n_codebooks == 4


@pytest.mark.parametrize("arch", MODAL)
def test_params_tree_and_converter_round_trip(arch):
    """The port's init has the reference's tree, shapes and dtypes (audio:
    a (K, Vp, d) embedding and a (K, d, Vp) head), and lm_from_jax /
    lm_to_numpy carry the reference's values there and back exactly, f32
    and bf16."""
    jcfg, cfg = _cfgs(arch)
    jparams = _np_params(jcfg)
    params = lm_from_jax(jparams, device="cpu")
    back = lm_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(back),
                    strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    mine = lm_to_numpy(init_params(cfg, seed=0, device="cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(mine)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    assert param_count(params) == sum(a.size for a in jax.tree.leaves(jparams))
    if cfg.n_codebooks:
        K, Vp, d = cfg.n_codebooks, cfg.vocab_padded, cfg.d_model
        assert params["embed"].shape == (K, Vp, d)
        assert params["lm_head"].shape == (K, d, Vp)
    jbf = _np_params(dataclasses.replace(jcfg, dtype="bfloat16"))
    bf = lm_from_jax(jbf, device="cpu")
    for a, b in zip(jax.tree.leaves(jbf), jax.tree.leaves(lm_to_numpy(bf))):
        np.testing.assert_array_equal(a.astype(np.float32), b)
    assert bf["embed"].dtype == torch.bfloat16


# -- the whole models with the reference's weights ----------------------------

@pytest.mark.parametrize("arch", MODAL)
def test_prefill_and_decode_match_reference(arch):
    """Text (or codebook) prompts: prefill, then teacher-forced decode
    steps, each step's logits and the cache against the reference's."""
    jcfg, cfg = _cfgs(arch)
    jparams = _np_params(jcfg)
    params = lm_from_jax(jparams, device="cpu")
    B, Sp, n_dec = 2, 40, 4
    S = Sp + n_dec
    tokens = _tokens(cfg, (B, S), 20)
    tt = torch.tensor(tokens)
    jcache = jtransformer.init_cache(jcfg, B, S)
    cache = transformer.init_cache(cfg, B, S, device="cpu")
    before = dict(ops.launches)
    want, jcache = jtransformer.prefill(jparams, jcfg, tokens[:, :Sp], jcache)
    got, cache = transformer.prefill(params, cfg, tt[:, :Sp], cache)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, **SLICE_TOL)
    for t in range(Sp, S):
        want, jcache = jtransformer.decode_step(
            jparams, jcfg, jcache, tokens[:, t:t + 1], jnp.int32(t))
        got, cache = transformer.decode_step(params, cfg, cache,
                                             tt[:, t:t + 1], t)
        assert got.shape == want.shape
        _close(got, want, **SLICE_TOL)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jcache)),
                    jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), cache)),
                    strict=True):
        _close(torch.tensor(b), a, **SLICE_TOL)
    assert ops.launches == before          # the CPU takes the plain versions


def test_llava_patch_prefill_then_decode_matches_reference():
    """The reference's own scenario (tests/test_decode.py:79-105): patch
    embeddings prepended at prefill, the cache sized P + S + 4, decode at
    positions P + t; each step against the reference's step and against
    the port's full forward over patches and text."""
    jcfg, cfg = _cfgs("llava-next-34b")
    jparams = _np_params(jcfg)
    params = lm_from_jax(jparams, device="cpu")
    B, S_text, Pn = 2, 24, cfg.n_patches
    tokens = _tokens(cfg, (B, S_text), 21)
    patch = (0.02 * np.random.default_rng(22).standard_normal(
        (B, Pn, cfg.d_model))).astype(np.float32)
    tt, tp = torch.tensor(tokens), torch.tensor(patch)
    h, _, _ = transformer.model_forward(params, cfg, tt, patch_emb=tp)
    assert h.shape == (B, Pn + S_text, cfg.d_model)
    full = transformer.logits_fn(params, cfg, h)[..., :cfg.vocab]
    jh, _, _ = jtransformer.model_forward(jparams, jcfg, tokens,
                                          patch_emb=patch)
    _close(h, jh, **SLICE_TOL)
    total = Pn + S_text
    jcache = jtransformer.init_cache(jcfg, B, total + 4)
    cache = transformer.init_cache(cfg, B, total + 4, device="cpu")
    want, jcache = jtransformer.prefill(jparams, jcfg, tokens[:, :S_text - 4],
                                        jcache, patch_emb=patch)
    got, cache = transformer.prefill(params, cfg, tt[:, :S_text - 4], cache,
                                     patch_emb=tp)
    _close(got, want, **SLICE_TOL)
    _close(got[:, 0], full[:, Pn + S_text - 5].numpy(), **SLICE_TOL)
    # the patches' positions sit in the cache ahead of the text's
    pos_map = cache["blocks"]["attn"]["pos_map"][0]
    assert pos_map[:Pn + S_text - 4].tolist() == list(range(Pn + S_text - 4))
    for t in range(S_text - 4, S_text):
        pos = Pn + t
        want, jcache = jtransformer.decode_step(
            jparams, jcfg, jcache, tokens[:, t:t + 1], jnp.int32(pos))
        got, cache = transformer.decode_step(params, cfg, cache,
                                             tt[:, t:t + 1], pos)
        _close(got, want, **SLICE_TOL)
        _close(got[:, 0], full[:, pos].numpy(), **SLICE_TOL)


def test_musicgen_logits_at_batch_equal_to_codebooks():
    """At B == K == 4 (serve's default batch, musicgen's codebooks) the
    logits are (B, 1, K, V), the reference's values: the head's (K,) dim
    is contracted per codebook, not broadcast against the batch."""
    jcfg, cfg = _cfgs("musicgen-medium")
    assert cfg.n_codebooks == 4
    jparams = _np_params(jcfg)
    params = lm_from_jax(jparams, device="cpu")
    B, S = 4, 16
    tokens = _tokens(cfg, (B, S), 23)
    jcache = jtransformer.init_cache(jcfg, B, S + 1)
    cache = transformer.init_cache(cfg, B, S + 1, device="cpu")
    want, _ = jtransformer.prefill(jparams, jcfg, tokens, jcache)
    got, _ = transformer.prefill(params, cfg, torch.tensor(tokens), cache)
    assert got.shape == (B, 1, cfg.n_codebooks, cfg.vocab) == want.shape
    _close(got, want, **SLICE_TOL)
    h = np.random.default_rng(24).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32)
    lg = transformer.logits_fn(params, cfg, torch.tensor(h))
    assert lg.shape == (B, 1, cfg.n_codebooks, cfg.vocab_padded)
    _close(lg, jtransformer.logits_fn(jparams, jcfg, h), **BLOCK_TOL)
    # the tied head reads the embedding per codebook, (K, Vp, d) -> (K, d, Vp)
    tied = {"embed": params["embed"]}
    jtied = {"embed": jparams["embed"]}
    _close(transformer.logits_fn(tied, cfg, torch.tensor(h)),
           jtransformer.logits_fn(jtied, jcfg, h), **BLOCK_TOL)


def test_embed_tokens_sums_codebooks_like_reference():
    jcfg, cfg = _cfgs("musicgen-medium")
    jparams = _np_params(jcfg)
    tokens = _tokens(cfg, (3, 7), 25)
    pos = np.arange(7, dtype=np.int32)
    want = jtransformer.embed_tokens(jparams, jcfg, tokens, pos)
    got = transformer.embed_tokens({"embed": torch.tensor(jparams["embed"])},
                                   cfg, torch.tensor(tokens),
                                   torch.tensor(pos))
    _close(got, want, **BLOCK_TOL)


# -- the serving entry point --------------------------------------------------

def test_sample_draws_one_id_per_codebook():
    gen = torch.Generator().manual_seed(0)
    lg = torch.full((4, 1, 4, 16), -1e30)
    lg[..., 3] = 0.0                       # every row puts its mass on id 3
    ids = serve_mod.sample(lg, 1.0, gen)
    assert ids.shape == (4, 1, 4) and bool((ids == 3).all())
    ids = serve_mod.sample(lg[:, :, 0], 1.0, gen)
    assert ids.shape == (4, 1) and bool((ids == 3).all())


@pytest.mark.parametrize("arch", MODAL)
def test_serve_prefill_matches_reference_on_its_prompts(arch):
    jcfg, cfg = _cfgs(arch)
    jparams = _np_params(jcfg)
    B, S, gen = 4, 12, 3
    out = serve_mod.serve(cfg, batch=B, prompt_len=S, gen=gen, seed=0,
                          device="cpu",
                          params=lm_from_jax(jparams, device="cpu"))
    K = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    assert out["prompts"].shape == (B, S, *K)
    assert out["tokens"].shape == (B, gen, *K)
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab)).all())
    assert out["logits"].shape == (B, 1, *K, cfg.vocab)
    assert torch.isfinite(out["logits"]).all()
    prompts = out["prompts"].numpy().astype(np.int32)
    want, _ = jtransformer.prefill(jparams, jcfg, prompts,
                                   jtransformer.init_cache(jcfg, B, S + gen))
    _close(out["prefill_logits"], want, **SLICE_TOL)


@pytest.mark.parametrize("arch", MODAL)
def test_serve_cli_runs_on_the_cpu(arch, capsys):
    serve_mod.main(["--device", "cpu", "--arch", arch, "--batch", "4",
                    "--prompt-len", "8", "--gen", "2"])
    out = capsys.readouterr().out
    assert f"serving {arch}" in out and "decode: 8 tokens" in out


class _Parsed(Exception):
    pass


def _default_args(main, monkeypatch):
    """The namespace ``main``'s parser makes of no arguments, caught at
    ``parse_args`` before anything runs."""
    def parse(self, args=None, namespace=None):
        raise _Parsed(argparse.ArgumentParser.parse_known_args(
            self, [], namespace)[0])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    with pytest.raises(_Parsed) as caught:
        main()
    return vars(caught.value.args[0])


@pytest.mark.parametrize("port,ref", [(serve_mod, jserve),
                                      (train_mod, jtrain),
                                      (fed_train_mod, jfed_train)],
                         ids=["serve", "train", "fed_train"])
def test_cli_defaults_match_reference(port, ref, monkeypatch):
    """The packages' serve, train and fed_train CLIs default to the same
    architecture (mamba2-130m) and every other flag the reference has to
    the same value; the port adds --device only."""
    mine = _default_args(port.main, monkeypatch)
    theirs = _default_args(ref.main, monkeypatch)
    assert mine["arch"] == theirs["arch"] == "mamba2-130m"
    assert mine.pop("device") is None
    assert mine == theirs
