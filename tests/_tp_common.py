"""Shared pieces of the model-axis tests (``test_torch_tp.py``,
``test_torch_tp_grad.py``): the inputs, the reference's single-device
runs, and the gloo ranks that run the port over a (1, m) grid.  jax is
imported only where the reference runs (the pytest process): a rank
loads this module and imports none of it."""
import pickle
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.core.fed_step import flatten_tree, unflatten_tree
from repro_torch.models.params import init_params, shard_params
from repro_torch.params import lm_from_jax, lm_to_numpy

BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
EP_TOL = dict(rtol=1e-5, atol=1e-5)
DELTA_TOL = 1e-4
FLIP_SHARE = 0.01
FLIP_ULPS = 2
ZERO_GRAD = ("attn/bk",)
ZERO_ATOL = 1e-6
WORLDS = (1, 2, 4)
GRAD_WORLD = 2
B, SP, N_DEC = 2, 72, 2         # the prompt past the reduced window (64)
GRAD_S = 16
MOE_ARCHS = ("deepseek-v2-lite-16b", "deepseek-v3-671b")


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def inputs_for(arch):
    """The weights in the reference's layout (deepseek-v3's router_bias
    drawn nonzero), the prompt and decode tokens, llava's patches, a
    training batch and an MoE layer's input."""
    cfg = get_config(arch).reduced()
    params = lm_to_numpy(init_params(cfg, seed=3, device="cpu"))
    rng = np.random.default_rng(7)
    if cfg.router_score == "sigmoid":
        for stack in ("moe_blocks",):
            rb = params[stack]["moe"]["router_bias"]
            params[stack]["moe"]["router_bias"] = (
                0.05 * rng.standard_normal(rb.shape)).astype(np.float32)
    K = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    out = dict(params=params,
               tokens=rng.integers(0, cfg.vocab, (B, SP + N_DEC, *K),
                                   dtype=np.int32),
               patches=None, batch=None, moe_x=None)
    if cfg.n_patches:
        out["patches"] = (0.02 * rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model))).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, GRAD_S + 1, *K), dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    out["batch"] = {"tokens": toks[:, :-1], "labels": labels}
    if cfg.n_patches:
        out["batch"]["patch_emb"] = out["patches"]
    if arch in MOE_ARCHS:
        out["moe_x"] = (0.1 * rng.standard_normal(
            (B, 16, cfg.d_model))).astype(np.float32)
    return out


def reference_serving(arch, inp):
    """The reference's prefill and teacher-forced decode logits and, for
    the MoE configs, ``_moe_ffn_dense`` and ``moe_ffn(ep=True)`` on a
    (1, 1) mesh at layer 0 of the MoE stack."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.launch.mesh import make_smoke_mesh as jmake_smoke_mesh
    from repro.models import moe as jmoe
    from repro.models import transformer as jtransformer
    from repro.models.sharding import use_mesh as juse_mesh
    jcfg = jget_config(arch).reduced()
    params = jax.tree.map(jnp.asarray, inp["params"])
    tokens, patches = inp["tokens"], inp["patches"]
    Pn = 0 if patches is None else patches.shape[1]
    prefill = jax.jit(lambda p, t, e: jtransformer.prefill(
        p, jcfg, t, jtransformer.init_cache(jcfg, B, Pn + SP + N_DEC),
        patch_emb=e))
    decode = jax.jit(lambda p, c, t, i: jtransformer.decode_step(
        p, jcfg, c, t, i))
    lg, cache = prefill(params, tokens[:, :SP], patches)
    out = {"logits": [np.asarray(lg)]}
    for t in range(SP, SP + N_DEC):
        lg, cache = decode(params, cache, tokens[:, t:t + 1],
                           jnp.int32(Pn + t))
        out["logits"].append(np.asarray(lg))
    if arch in MOE_ARCHS:
        p = jax.tree.map(lambda a: a[0], params["moe_blocks"]["moe"])
        x = jnp.asarray(inp["moe_x"])
        y, aux = jax.jit(lambda p, x: jmoe._moe_ffn_dense(p, x, jcfg))(p, x)
        with juse_mesh(jmake_smoke_mesh(1, 1)):
            y1, aux1 = jax.jit(lambda p, x: jmoe.moe_ffn(
                p, x, jcfg, ep=True))(p, x)
        out["moe"] = dict(dense=(np.asarray(y), float(aux)),
                          ep1=(np.asarray(y1), float(aux1)))
    return out


def reference_grads(arch, inp):
    """The reference's train_loss gradients, as the port's flat leaves."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.models import transformer as jtransformer
    jcfg = jget_config(arch).reduced()
    params = jax.tree.map(jnp.asarray, inp["params"])
    grads = jax.jit(jax.grad(lambda p, b: jtransformer.train_loss(
        p, jcfg, b)))(params, jax.tree.map(jnp.asarray, inp["batch"]))
    return flatten_tree(lm_from_jax(_np(grads), device="cpu"))


def _serve(params, cfg, inp, grid):
    from repro_torch.models import transformer
    from repro_torch.models.sharding import use_mesh
    tokens = torch.from_numpy(inp["tokens"]).long()
    patches = None if inp["patches"] is None else \
        torch.from_numpy(inp["patches"])
    Pn = 0 if patches is None else patches.shape[1]
    with use_mesh(grid), torch.no_grad():
        cache = transformer.init_cache(cfg, B, Pn + SP + N_DEC,
                                       device="cpu")
        lg, cache = transformer.prefill(params, cfg, tokens[:, :SP], cache,
                                        patch_emb=patches)
        out = [lg]
        for t in range(SP, SP + N_DEC):
            lg, cache = transformer.decode_step(params, cfg, cache,
                                                tokens[:, t:t + 1], Pn + t)
            out.append(lg)
    return [x.numpy() for x in out]


def _grads(params, cfg, inp, grid):
    """train_loss's gradients on the rank's shards, the backward pass taken
    outside the grid's context, as autograd's device thread takes it on
    the card (the checkpointed loss chunks recompute under the forward's
    grid all the same)."""
    from repro_torch.models import transformer
    from repro_torch.models.sharding import use_mesh
    leaves = {k: v.detach().requires_grad_()
              for k, v in flatten_tree(params).items()}
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    with use_mesh(grid):
        loss = transformer.train_loss(unflatten_tree(leaves), cfg, batch)
    g = torch.autograd.grad(loss, list(leaves.values()),
                            materialize_grads=True)
    return {k: v.numpy() for k, v in zip(leaves, g)}


def _ep(params, cfg, inp, grid):
    from repro_torch.models import moe
    from repro_torch.models.sharding import model_axis, use_mesh
    p = {k: v[0] for k, v in flatten_tree(params["moe_blocks"]["moe"])
         .items()}
    p = shard_params(unflatten_tree(p), cfg, grid)
    with use_mesh(grid), torch.no_grad():
        y, aux = moe._moe_ffn_ep(p, torch.from_numpy(inp["moe_x"]), cfg,
                                 model_axis(grid, single=True))
    return y.numpy(), float(aux)


def _rank_main(rank, world, init_file, out_dir, inputs_file, jobs):
    torch.set_num_threads(1)
    from repro_torch.launch.cluster import init_distributed
    from repro_torch.launch.mesh import make_smoke_mesh
    dist = init_distributed(f"file://{init_file}", world, rank,
                            backend="gloo")
    try:
        with open(inputs_file, "rb") as f:
            inputs = pickle.load(f)
        grid = make_smoke_mesh(1, world)
        out = {"coord": grid.coord("model")}
        try:
            make_smoke_mesh(1, 2 * world)
        except ValueError as e:
            out["mismatch"] = str(e)
        for arch, inp in inputs.items():
            cfg = get_config(arch).reduced()
            full = lm_from_jax(inp["params"], device="cpu")
            local = shard_params(full, cfg, grid)
            res = {}
            if "serve" in jobs:
                res["logits"] = _serve(local, cfg, inp, grid)
                if world == 1:
                    res["unsharded"] = _serve(full, cfg, inp, None)
            if "grads" in jobs:
                res["grads"] = _grads(local, cfg, inp, grid)
            if "ep" in jobs and arch in MOE_ARCHS:
                res["ep"] = _ep(full, cfg, inp, grid)
            out[arch] = res
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_worlds(inputs, tmp, worlds, jobs):
    """Start each world's gloo ranks once: {world: [rank results]}."""
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    out = {}
    for world in worlds:
        d = tmp / f"w{world}"
        d.mkdir()
        mp.spawn(_rank_main, nprocs=world, join=True,
                 args=(world, str(d / "pg"), str(d), str(tmp / "inputs.pkl"),
                       tuple(jobs)))
        out[world] = []
        for r in range(world):
            with open(d / f"rank{r}.pkl", "rb") as f:
                out[world].append(pickle.load(f))
    return out


class Row:
    """A grid's shape and one rank's coordinate, for cutting the
    reference's full leaves as that rank's shards."""

    def __init__(self, m, r):
        self.shape, self.r = {"data": 1, "model": m}, r
        self.axis_names = ("data", "model")

    def coord(self, axes):
        return self.r




def close_grad(name, got, want, top):
    """One leaf's gradient: within DELTA_TOL of the reference leaf's norm
    after the elements at most FLIP_ULPS ulps apart are set aside where
    they are at most FLIP_SHARE of the leaf; an exactly zero gradient
    (rounding noise on both sides) held to zero within ZERO_ATOL x top."""
    if name.endswith(ZERO_GRAD) and np.abs(want).max() <= ZERO_ATOL * top:
        assert np.abs(got).max() <= ZERO_ATOL * top, name
        return
    diff = got.astype(np.float64) - want
    big = np.maximum(np.abs(got), np.abs(want)).astype(np.float32)
    flips = (diff != 0) & (np.abs(diff) <= FLIP_ULPS * np.spacing(big))
    if flips.mean() <= FLIP_SHARE:
        diff = np.where(flips, 0.0, diff)
    norm = np.linalg.norm(want)
    assert np.linalg.norm(diff) <= DELTA_TOL * norm, \
        (name, np.linalg.norm(diff), norm)
