"""The port's grids, rule table and layout against the reference, in one
process: ``repro_torch.launch.mesh``, ``launch.cluster``,
``models.sharding`` (``tree_param_specs``, ``local_shape``),
``fed.sharding``'s composite federation axes and ``launch.steps``'s
placements.

* ``tree_param_specs`` equals the reference's for every id of
  ``ARCH_IDS``, with fsdp off and on;
* every leaf's local shard shape on the production layouts, (16, 16) and
  (2, 16, 16), is what the reference's spec gives, except at the stated
  departures (``models.sharding``): a copied KV head where 16 % KV == 0,
  and the SSM's conv channels (its x block and every B and C channel);
* the reference's divisibility checks (``tests/test_sharding_specs.py``)
  and its composite-axis tests, ported;
* the steps' placements on a (1, 1) grid against the reference's
  shardings on its smoke mesh, but at the stated cache departures;
* ``cluster``'s argument parsing and its ``runpy`` hand-off (one gloo rank
  in a subprocess), and the builders' refusal without a process group.
"""
import functools
import math
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import INPUT_SHAPES as JINPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.fed.sharding import FedSharding as JFedSharding
from repro.launch import steps as jsteps
from repro.launch.mesh import make_smoke_mesh as jmake_smoke_mesh
from repro.models.sharding import tree_param_specs as jtree_param_specs
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.core.fed_step import flatten_tree
from repro_torch.fed.sharding import FedSharding, make_fed_sharding
from repro_torch.launch import cluster, mesh, steps
from repro_torch.launch.mesh import Grid
from repro_torch.models.sharding import (_filter_spec, check_heads,
                                         local_shape, tree_param_specs)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH_AXES = {"pod": 2, "data": 16, "model": 16}
LAYOUTS = {"(16, 16)": ("data", "model"),
           "(2, 16, 16)": ("pod", "data", "model")}
# the configs whose heads, KV heads and experts split whole over 16 model
# ranks (the port runs attention and SSD by whole heads; the reference's
# GSPMD may split a head)
RUN_AT_16 = ["gemma-7b", "command-r-plus-104b", "deepseek-v2-lite-16b",
             "nemotron-4-15b", "deepseek-v3-671b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_jabstract_params, _abstract_params = jsteps.abstract_params, \
    steps.abstract_params


@functools.lru_cache(maxsize=None)
def _jabstract(arch):
    return _jabstract_params(jget_config(arch))


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    return _abstract_params(get_config(arch))


def _jflat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_jflat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _grid(names, sizes=None):
    """A grid's geometry without a process group (its groups unused)."""
    sizes = sizes or tuple(MESH_AXES[a] for a in names)
    keys = [(a,) for a in names] + ([("pod", "data")]
                                    if "pod" in names else [])
    return Grid(tuple(names), tuple(sizes), (0,) * len(names),
                {k: None for k in keys})


# -- the rule table -----------------------------------------------------------

@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tree_param_specs_match_reference(arch, fsdp):
    want = _jflat(jtree_param_specs(_jabstract(arch), fsdp=fsdp))
    got = flatten_tree(tree_param_specs(_abstract(arch), fsdp=fsdp))
    assert list(got) == list(want)
    for name, spec in got.items():
        assert spec == tuple(want[name]), name


def _reference_local(shape, spec, sizes):
    return tuple(d // math.prod(sizes.get(a, 1) for a in
                                (e if isinstance(e, tuple) else (e,)))
                 if e is not None else d for d, e in zip(shape, spec))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_local_shard_shapes_follow_the_reference_spec(arch, fsdp, layout):
    names = LAYOUTS[layout]
    sizes = {a: MESH_AXES[a] for a in names}
    grid = _grid(names)
    cfg = get_config(arch)
    m, KV = sizes["model"], cfg.n_kv_heads
    jleaves = _jflat(_jabstract(arch))
    specs = flatten_tree(tree_param_specs(_abstract(arch), fsdp=fsdp))
    departures = 0
    for name, leaf in flatten_tree(_abstract(arch)).items():
        spec = _filter_spec(specs[name], grid)
        shape = tuple(leaf.shape)
        assert shape == tuple(jleaves[name].shape), name
        want = list(_reference_local(shape, spec, sizes))
        last = name.split("/")[-1]
        if last in ("wk", "wv", "bk", "bv") and not cfg.use_mla \
                and KV % m and m % KV == 0:
            want[-1] = cfg.head_dim          # departure 1: a copied head
            departures += 1
        if last in ("conv_w", "conv_b"):     # the x block, B and C whole
            want[-1] = cfg.d_inner // m + 2 * cfg.ssm_n_groups * \
                cfg.ssm_d_state
            departures += 1
        assert local_shape(name, shape, spec, cfg, sizes) == tuple(want), \
            name
    copies = bool(cfg.n_heads) and not cfg.use_mla and KV % m and \
        m % KV == 0
    ssm = cfg.family in ("ssm", "hybrid")
    assert bool(departures) == bool(copies or ssm)


# -- divisibility (tests/test_sharding_specs.py) -----------------------------

def _check_divisible(specs, shapes, where):
    for name, spec in specs.items():
        for dim, entry in zip(shapes[name], spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            n = math.prod(MESH_AXES[a] for a in axes)
            assert dim % n == 0, (where, name, shapes[name], spec, dim, n)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_divisible(arch, fsdp):
    specs = flatten_tree(tree_param_specs(_abstract(arch), fsdp=fsdp))
    shapes = {k: tuple(v.shape)
              for k, v in flatten_tree(_abstract(arch)).items()}
    _check_divisible(specs, shapes, f"{arch} fsdp={fsdp}")


@pytest.mark.parametrize("arch,shape_name", [
    (a, s) for a in ARCH_IDS for s in ("decode_32k", "long_500k")
    if get_config(a).supports_shape(s)])
def test_cache_specs_divisible(arch, shape_name):
    """The reference's cache rule (its test reproduces ``steps.py``'s) on
    the port's cache shapes, which are the reference's; long_500k only
    where the config supports it."""
    from repro_torch.models import transformer
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    cache = flatten_tree(transformer.init_cache(
        cfg, shape.global_batch, shape.seq_len, device="meta"))

    def spec_for(name, ndim):
        last = name.split("/")[-1]
        if last in ("k", "v", "conv"):
            return (None, None, None, "model")
        if last in ("ckv", "krope"):
            return (None, None, "model", None)
        if last == "state":
            return (None, None, None, None, "model", None)
        return (None,) * ndim

    _check_divisible({k: spec_for(k, v.ndim) for k, v in cache.items()},
                     {k: tuple(v.shape) for k, v in cache.items()},
                     f"{arch} {shape_name}")


def test_which_configs_split_by_whole_heads_at_16():
    """The port cuts heads whole; at 16 model ranks these configs split
    (the others raise, and run at a model axis their heads divide)."""
    runs = []
    for arch in ARCH_IDS:
        try:
            check_heads(get_config(arch), 16)
            runs.append(arch)
        except ValueError as e:
            assert "do not split" in str(e) or "cannot be laid" in str(e)
    assert sorted(runs) == sorted(RUN_AT_16)
    for arch in ARCH_IDS:
        check_heads(get_config(arch).reduced(), 4)


# -- composite federation axes (tests/test_sharding_specs.py) ----------------

def test_composite_fed_axis_specs():
    g = _grid(("pod", "data", "model"), (1, 1, 1))
    fs = FedSharding(mesh=g, axis=("pod", "data"))
    jfs = JFedSharding(mesh=jax.make_mesh((1, 1, 1), ("pod", "data",
                                                      "model")),
                       axis=("pod", "data"))
    assert fs.axes == jfs.axes == ("pod", "data")
    assert fs.client_spec(2) == tuple(jfs.client_spec(2)) == \
        (("pod", "data"), None)
    assert fs.client_spec(4, axis_dim=1) == tuple(jfs.client_spec(4, 1))
    fs1 = FedSharding(mesh=g, axis="data")
    assert fs1.client_spec(2) == ("data", None)
    assert fs.n_shards == 1 and fs.rank == 0


def test_composite_fed_axis_padding_ownership():
    """pad_capacity over the product of the axes (pod 2 x data 3), whole
    slots per shard, idempotent; each shard's slots."""
    g = _grid(("pod", "data", "model"), (2, 3, 1))
    fs = FedSharding(mesh=g, axis=("pod", "data"))
    assert fs.n_shards == 6
    assert [fs.pad_capacity(c) for c in (1, 5, 6, 7, 12, 13)] == \
        [6, 6, 6, 12, 12, 18]
    for c in (1, 5, 6, 7, 12, 13):
        assert fs.pad_capacity(fs.pad_capacity(c)) == fs.pad_capacity(c)
        assert fs.pad_capacity(c) % fs.n_shards == 0
    owned = [FedSharding(n_shards=6, rank=r).slots(12) for r in range(6)]
    assert [list(s) for s in owned] == [[2 * r, 2 * r + 1]
                                        for r in range(6)]


def test_composite_fed_axis_validation():
    g = _grid(("data", "model"), (1, 1))
    with pytest.raises(ValueError, match="no 'pod' axis") as mine:
        FedSharding(mesh=g, axis=("pod", "data"))
    with pytest.raises(ValueError) as theirs:
        JFedSharding(mesh=jax.make_mesh((1, 1), ("data", "model")),
                     axis=("pod", "data"))
    assert str(mine.value) == str(theirs.value)


def test_fed_param_sharding_filters_missing_axes():
    fs = FedSharding(mesh=_grid(("data", "model"), (1, 1)), axis="data")
    assert fs.param_sharding((("pod", "data"), "model")) == \
        ("data", "model")
    assert fs.param_sharding(None) == ()
    jfs = JFedSharding(mesh=jax.make_mesh((1, 1), ("data", "model")))
    assert tuple(jfs.param_sharding(P(("pod", "data"), "model")).spec) == \
        ("data", "model")


def test_put_params_cuts_and_checks_the_model_axis():
    """put_params cuts each full leaf to the rank's shard (the rank's
    contiguous block of wq, a copied KV head at 4 ranks), lets a leaf at
    its shard's shape pass, and refuses a leaf of neither shape;
    constrain_params checks the layout."""
    from repro_torch.fed.task import LMTask
    cfg = get_config("nemotron-4-15b").reduced()
    task = LMTask(cfg, seq_len=8, fsdp=False)
    full = task.init_params(0, device="cpu")
    specs = task.param_specs(full)
    shapes = task.full_shapes()
    grid = Grid(("data", "model"), (1, 4), (0, 3),
                {("data",): None, ("model",): None})
    fs = FedSharding(mesh=grid, axis="data")
    local = fs.put_params(full, specs, cfg=cfg)
    hd = cfg.head_dim
    wq = full["blocks/attn/wq"]
    assert torch.equal(local["blocks/attn/wq"], wq[..., 3 * hd:4 * hd])
    assert torch.equal(local["blocks/attn/wk"],
                       full["blocks/attn/wk"][..., hd:2 * hd])
    assert local["blocks/ln1/scale"] is full["blocks/ln1/scale"]
    again = fs.put_params(local, specs, cfg=cfg, full=shapes)
    assert all(again[k] is local[k] for k in local)
    assert fs.constrain_params(local, specs, cfg=cfg, full=shapes) is local
    bad = dict(local, **{"blocks/attn/wq": wq[..., :hd * 2]})
    with pytest.raises(ValueError, match="blocks/attn/wq"):
        fs.put_params(bad, specs, cfg=cfg, full=shapes)
    with pytest.raises(ValueError, match="neither the full"):
        fs.constrain_params(full, specs, cfg=cfg, full=shapes)


# -- the steps' placements -----------------------------------------------------

def _jspecs(tree):
    if isinstance(tree, dict):
        return {k: _jspecs(v) for k, v in tree.items()}
    return tuple(tree.spec)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_placements_match_reference(arch, monkeypatch):
    """On a (1, 1) grid, every step's per-input placement equals the
    reference's sharding on its smoke mesh, axis names filtered alike;
    the cache's at the stated departures: the MLA latents replicated,
    the SSM state split by heads (dim 3), not by head dim."""
    monkeypatch.setattr(jsteps, "abstract_params",
                        lambda cfg: _jabstract(cfg.name))
    monkeypatch.setattr(steps, "abstract_params",
                        lambda cfg: _abstract(cfg.name))
    jcfg, cfg = jget_config(arch), get_config(arch)
    jmesh, grid = jmake_smoke_mesh(1, 1), _grid(("data", "model"), (1, 1))
    for name, shape in INPUT_SHAPES.items():
        if shape.kind == "train" and cfg.fed.mode != "client_parallel":
            with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
                steps.make_step(cfg, shape, mesh=grid)
            continue
        want = jsteps.make_step(jcfg, JINPUT_SHAPES[name], jmesh)
        got = steps.make_step(cfg, shape, mesh=grid)
        assert got.meta == want.meta
        for g, w in zip(got.in_shardings, want.in_shardings, strict=True):
            w = _jspecs(w)
            if shape.kind == "decode" and isinstance(w, dict) and \
                    "embed" not in w:
                w = flatten_tree(w)
                for k in w:
                    last = k.split("/")[-1]
                    if last in ("ckv", "krope"):
                        w[k] = (None, w[k][1], None, None)
                    elif last == "state":
                        w[k] = (None, w[k][1], None, "model", None, None)
                g = flatten_tree(g)
            assert g == w, name


# -- grids and the cluster ----------------------------------------------------

def test_grid_builders_refuse_without_a_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    for build in (mesh.make_production_mesh,
                  functools.partial(mesh.make_production_mesh,
                                    multi_pod=True),
                  mesh.make_smoke_mesh, mesh.make_data_mesh):
        with pytest.raises(RuntimeError, match="process group"):
            build()
    with pytest.raises(RuntimeError, match="process group"):
        make_fed_sharding()
    assert mesh.HBM_BYTES_PER_S == 3.35e12 and mesh.BF16_FLOPS_PER_S == 989e12


def test_cluster_parses_the_reference_flags(monkeypatch):
    monkeypatch.delenv("REPRO_COORDINATOR", raising=False)
    args = cluster.parse_args(["--coordinator", "10.0.0.1:8476",
                               "--num-processes", "4", "--process-id", "2",
                               "--", "python", "-m", "x.y", "--data", "2"])
    assert (args.coordinator, args.num_processes, args.process_id,
            args.backend) == ("10.0.0.1:8476", 4, 2, "nccl")
    assert args.cmd == ["--", "python", "-m", "x.y", "--data", "2"]
    assert cluster._init_method("10.0.0.1:8476") == "tcp://10.0.0.1:8476"
    assert cluster._init_method("file:///tmp/pg") == "file:///tmp/pg"
    monkeypatch.setenv("REPRO_COORDINATOR", "h:1")
    assert cluster.parse_args([]).coordinator == "h:1"
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        cluster._init_method(None)
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        cluster.init_distributed(backend="gloo")
    with pytest.raises(ValueError, match="backend"):
        cluster.init_distributed("h:1", 1, 0, backend="mpi")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            cluster.init_distributed("h:1", 1, 0)


def test_cluster_runs_the_command_on_an_initialised_rank(tmp_path):
    """``python -m repro_torch.launch.cluster ... -- python script.py``:
    the script runs in the rank's process (runpy), its argv the
    command's, over the initialised world, and the group is destroyed
    after it."""
    script = tmp_path / "job.py"
    script.write_text(
        "import sys, torch.distributed as dist\n"
        "from repro_torch.launch.mesh import make_smoke_mesh\n"
        "g = make_smoke_mesh(1, 1)\n"
        "print('job', sys.argv[1:], dist.get_world_size(), dict(g.shape))\n")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cluster",
         "--coordinator", f"file://{tmp_path / 'pg'}", "--num-processes",
         "1", "--process-id", "0", "--backend", "gloo", "--", "python",
         str(script), "--flag", "3"],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "[cluster] process 0/1 backend=gloo" in out.stdout
    assert "job ['--flag', '3'] 1 {'data': 1, 'model': 1}" in out.stdout
