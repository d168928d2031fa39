"""The LM federation through the device-resident engine against the
reference: ``fed.LMTask``, the engine and the scheduler over an LM task,
``core.fed_step.fed_train_step``, ``launch/steps.py``,
``launch/fed_train.py`` and an MoE federation's checkpoint in both
directions.  Reduced configs in f32, short sequences and a few samples;
one module fixture for each reference run that several tests read: the
reference's client-parallel round is its ``fed_train_step`` on a plan's
gathered batches, which both the port's engine span and its
``fed_train_step`` are held to (one compile of the reference's LM round
costs seconds here, and the suite runs near its time limit).

Tolerances: a round's new params per leaf within DELTA_TOL of the
reference delta's norm, after the elements at most R (E + 1) ulps apart
are set aside where they are at most FLIP_SHARE of the leaf (ROADMAP
Limits item 8, ``tests/test_torch_lm_train.py``); the port's parallel
round against its sequential one within the reference's own check
(``tests/test_fedmodel.py``: rtol 2e-3, atol 2e-5).  Round records, the
device draws, the fleet, token streams, input specs and checkpoints are
equal."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import load_fed_checkpoint as jload_fed_checkpoint
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import INPUT_SHAPES as JINPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.core.fed_step import fed_train_step as jfed_train_step
from repro.fed import LMTask as JLMTask
from repro.fed import RoundEngine as JRoundEngine
from repro.fed import StreamScheduler as JStreamScheduler
from repro.fed import engine as ref_engine
from repro.launch import fed_train as jfed_train
from repro.launch import steps as jsteps
from repro.launch.mesh import make_smoke_mesh
from repro.models.params import init_params as jinit_params
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.core import prng
from repro_torch.core.aggregation import (flatten_for_wire,
                                          scheme_coefficients)
from repro_torch.core.compression import compress_flat, resolve_compression
from repro_torch.core.fed_step import (fed_train_step, flatten_tree,
                                       local_sgd, unflatten_tree)
from repro_torch.data import fed_lm_batches
from repro_torch.fed import (Arrival, Departure, LMTask, RoundEngine,
                             StreamScheduler)
from repro_torch.fed import engine as port_engine
from repro_torch.kernels import ops
from repro_torch.launch import fed_train, steps
from repro_torch.params import lm_from_jax, lm_to_numpy

SEQ, SAMPLES, E, B = 16, 6, 2, 2
N_CLIENTS = 3
ROUNDS = 1
ETA0 = 0.1
DELTA_TOL = 1e-4
FLIP_SHARE = 0.01
PARALLEL_VS_SEQUENTIAL = dict(rtol=2e-3, atol=2e-5)
KEY_SEED = 1
MOE = "deepseek-v2-lite-16b"
# the reference's parameter draw, compiled once for every use in this file
# (the reference's fed_train draws op by op, three times slower here)
jinit = jax.jit(jinit_params, static_argnums=1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_leaves(got: dict, want: dict, start: dict, ulps: int,
                  slack=None) -> None:
    """Each leaf of got within DELTA_TOL of want's delta norm from start,
    after the elements at most ``ulps`` ulps apart are set aside where
    they are at most FLIP_SHARE of the leaf; ``slack`` ({name: tensor}),
    where given, is first taken off each element's difference."""
    assert list(got) == list(want)
    for name, p in got.items():
        w = want[name]
        diff = p - w
        if slack is not None:
            diff = diff.sign() * (diff.abs() - slack[name]).clamp_min(0.0)
        top = torch.maximum(p.abs(), w.abs())
        flips = (diff != 0) & (diff.abs() <= ulps * (
            torch.nextafter(top, torch.tensor(float("inf"))) - top))
        share = flips.float().mean().item()
        if share <= FLIP_SHARE:
            diff = diff.masked_fill(flips, 0.0)
        norm = (w - start[name]).norm().item()
        assert diff.norm().item() <= DELTA_TOL * norm, \
            (name, diff.norm().item(), norm, share)


def _flat_np(jtree) -> dict:
    """A reference tree as the port's flat CPU leaves."""
    return flatten_tree(lm_from_jax(jax.tree.map(np.asarray, jtree),
                                    device="cpu"))


# -- LMTask and the fleet -----------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-130m", "musicgen-medium"])
def test_lm_task_matches_reference(arch):
    """buffers, token_stream, client_arrays (and its refusal), make_batch
    on the text and the codebook layouts, and init_params' keys, shapes
    and dtypes."""
    jtask = JLMTask(jget_config(arch).reduced(), seq_len=SEQ)
    task = LMTask(get_config(arch).reduced(), seq_len=SEQ)
    assert task.buffers["tokens"].shape == jtask.buffers["tokens"].shape
    assert task.buffers["tokens"].dtype == jtask.buffers["tokens"].dtype
    for domain in (0, 3):
        got = task.token_stream(np.random.default_rng(4), n=5, domain=domain)
        want = jtask.token_stream(np.random.default_rng(4), n=5,
                                  domain=domain)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    client = jfed_train.build_fleet(jtask, n_clients=1, samples=4, seed=2)[0]
    np.testing.assert_array_equal(task.client_arrays(client)["tokens"],
                                  jtask.client_arrays(client)["tokens"])
    bad = dataclasses.replace(client, x=client.x[:, :-1])
    with pytest.raises(ValueError) as theirs:
        jtask.client_arrays(bad)
    with pytest.raises(ValueError) as mine:
        task.client_arrays(bad)
    assert str(mine.value) == str(theirs.value)
    # gathered (C, E, B) + spec.shape, as the engine gathers it
    t = np.random.default_rng(5).integers(
        0, 100, (2, E, B) + task.buffers["tokens"].shape, dtype=np.int32)
    got = task.make_batch({"tokens": torch.from_numpy(t)})
    want = jtask.make_batch({"tokens": jnp.asarray(t)})
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    shapes = jax.eval_shape(jtask.init_params, jax.random.PRNGKey(0))
    mine = task.init_params(0, device="cpu")
    want = {"/".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert list(mine) == list(want)
    for name, leaf in mine.items():
        assert tuple(leaf.shape) == want[name].shape
        assert str(leaf.dtype).removeprefix("torch.") == str(
            want[name].dtype)
    # the rule table's specs, keyed as the leaves (the reference's
    # param_specs over its tree)
    jspecs = jtask.param_specs(shapes)
    want = {"/".join(k.key for k in path): tuple(spec) for path, spec in
            jax.tree_util.tree_flatten_with_path(
                jspecs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}
    assert task.param_specs(mine) == want


def test_build_fleet_matches_reference():
    jtask = JLMTask(jget_config("mamba2-130m").reduced(), seq_len=SEQ)
    task = LMTask(get_config("mamba2-130m").reduced(), seq_len=SEQ)
    want = jfed_train.build_fleet(jtask, n_clients=7, samples=SAMPLES,
                                  seed=3)
    got = fed_train.build_fleet(task, n_clients=7, samples=SAMPLES, seed=3)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.x, w.x)
        assert g.x.dtype == w.x.dtype and g.n == w.n
        assert dataclasses.asdict(g.trace) == dataclasses.asdict(w.trace)


# -- the engine over an LM task ------------------------------------------------

def _span_kwargs(cap: int) -> dict:
    return dict(p=np.full(cap, 1 / N_CLIENTS, np.float32),
                lr_shift_tau=0, reboot_tau0=np.zeros(cap, np.int32),
                reboot_boost=np.ones(cap, np.float32))


@pytest.fixture(scope="module")
def mamba():
    """Reduced mamba2-130m: both packages' tasks and fleets, and the
    reference's initial params (as the port's flat leaves too)."""
    jcfg = jget_config("mamba2-130m").reduced()
    cfg = get_config("mamba2-130m").reduced()
    jtask = JLMTask(jcfg, seq_len=SEQ)
    jparams = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jcfg))
    task = LMTask(cfg, seq_len=SEQ)
    return dict(jtask=jtask, task=task, jparams=jparams,
                start=_flat_np(jparams),
                jclients=jfed_train.build_fleet(jtask, n_clients=N_CLIENTS,
                                                samples=SAMPLES, seed=0),
                clients=fed_train.build_fleet(task, n_clients=N_CLIENTS,
                                              samples=SAMPLES, seed=0))


@pytest.fixture(scope="module")
def spans(mamba):
    """One plan-mode span of ROUNDS rounds (a masked step and a dark
    client) from the reference's params, in each engine mode of the port,
    and the reference's: its engine's client-sequential span, and its
    client-parallel round as ``repro.core.fed_step.fed_train_step`` (scheme
    C at eta0, what the engine's first round computes, boost and LR shift
    at their nulls) on the plan's batches, gathered from the clients' token
    rows.  The records of the reference's engine (s, eta) do not depend on
    its mode.  Then the same span on the int8 wire: the port's
    client-parallel engine and the reference's client-sequential one.
    {mode: (port params, port metrics)}, "int8": (port params, port
    metrics), "reference": (params after the sequential span, its metrics,
    params after the parallel round), "reference_int8": (params, metrics),
    "plan", "batches"."""
    rng = np.random.default_rng(0)
    alphas = np.ones((ROUNDS, N_CLIENTS, E), np.float32)
    alphas[0, 1, 1] = 0.0
    alphas[0, 2] = 0.0
    plan = (alphas, rng.integers(0, SAMPLES, (ROUNDS, N_CLIENTS, E, B)))
    kw = dict(active=np.ones(N_CLIENTS, np.float32), **_span_kwargs(
        N_CLIENTS))
    jeng = JRoundEngine(task=mamba["jtask"], clients=mamba["jclients"],
                        local_epochs=E, batch_size=B, eta0=ETA0,
                        mode="client_sequential")
    jseq, jm = jeng.run_span(jax.tree.map(jnp.asarray, mamba["jparams"]),
                             0, ROUNDS, plan=plan, **kw)
    jeng8 = JRoundEngine(task=mamba["jtask"], clients=mamba["jclients"],
                         local_epochs=E, batch_size=B, eta0=ETA0,
                         mode="client_sequential", compression="int8")
    jseq8, jm8 = jeng8.run_span(
        jax.tree.map(jnp.asarray, mamba["jparams"]), 0, ROUNDS, plan=plan,
        **kw)
    tokens = np.stack([c.x[plan[1][0, i]]
                       for i, c in enumerate(mamba["jclients"])])
    batches = mamba["jtask"].make_batch({"tokens": tokens})
    jpar, _ = jax.jit(functools.partial(
        jfed_train_step, mamba["jtask"].loss_fn, mamba["jtask"].cfg))(
        mamba["jparams"], batches, alphas[0], kw["p"], jnp.float32(ETA0))
    out = {"reference": (_flat_np(jseq), jm, _flat_np(jpar)),
           "reference_int8": (_flat_np(jseq8), jm8), "plan": plan,
           "batches": batches}
    for name, mode, wire in (("client_parallel", "client_parallel", None),
                             ("client_sequential", "client_sequential",
                              None),
                             ("int8", "client_parallel", "int8")):
        eng = RoundEngine(task=mamba["task"], clients=mamba["clients"],
                          local_epochs=E, batch_size=B, eta0=ETA0, mode=mode,
                          compression=wire, device="cpu")
        params = {k: v.clone() for k, v in mamba["start"].items()}
        before = dict(ops.launches)
        out[name] = eng.run_span(params, 0, ROUNDS, plan=plan, **kw)
        assert ops.launches == before            # the CPU: plain versions
    return out


@pytest.mark.parametrize("mode", ["client_parallel", "client_sequential"])
def test_engine_span_matches_reference(spans, mamba, mode):
    new, m = spans[mode]
    jseq, jm, jpar = spans["reference"]
    np.testing.assert_array_equal(m["s"].numpy(), np.asarray(jm["s"]))
    np.testing.assert_array_equal(m["eta"].numpy(), np.asarray(jm["eta"]))
    want = jpar if mode == "client_parallel" else jseq
    _close_leaves(new, want, mamba["start"], ROUNDS * (E + 1))


def test_int8_span_matches_reference(spans, mamba):
    """The int8 wire over the LM's flat leaves: the port's client-parallel
    span (one (C, D) buffer cut into chunks of one scale each) against the
    reference engine's client-sequential span (each client's row cut on
    the same grid, ``repro.core.compression.round_trip_tree``).  Equal
    records, and each leaf within the rule above once one code step per
    client is taken off each element: the most that a rounding which
    flips between the packages moves it (``tests/test_torch_quant.py``),
    sum_k |c_k| * scale_k, from the port's own deltas.  A chunk grid that
    differed would move whole chunks by many steps."""
    new, m = spans["int8"]
    want, jm = spans["reference_int8"]
    np.testing.assert_array_equal(m["s"].numpy(), np.asarray(jm["s"]))
    np.testing.assert_array_equal(m["eta"].numpy(), np.asarray(jm["eta"]))
    start, spec = mamba["start"], resolve_compression("int8")
    alpha = torch.from_numpy(spans["plan"][0][0])
    deltas = local_sgd(mamba["task"].loss_fn, start,
                       {k: torch.from_numpy(np.asarray(v))
                        for k, v in spans["batches"].items()},
                       alpha, torch.tensor(ETA0))
    flat, _ = flatten_for_wire(start, deltas, spec)
    steps = compress_flat(flat, spec)[1].repeat_interleave(
        spec.chunk, 1)[:, :flat.shape[1]]
    coeffs = scheme_coefficients(
        "C", torch.full((N_CLIENTS,), 1 / N_CLIENTS), alpha.sum(1), E)
    bound, slack, off = coeffs.abs() @ steps, {}, 0
    for name in sorted(start):
        n = start[name].numel()
        slack[name] = bound[off:off + n].reshape(start[name].shape)
        off += n
    assert any(not torch.equal(p, start[k]) for k, p in new.items())
    _close_leaves(new, want, start, ROUNDS * (E + 1), slack=slack)


def test_engine_parallel_and_sequential_agree(spans, mamba):
    """The reference's own check (tests/test_fedmodel.py) on the port: the
    same plan in both modes gives finite, changed params within rtol 2e-3,
    atol 2e-5."""
    par, seq = spans["client_parallel"][0], spans["client_sequential"][0]
    changed = 0
    for name, p in par.items():
        assert torch.isfinite(p).all() and torch.isfinite(seq[name]).all()
        changed += not torch.equal(p, mamba["start"][name])
        np.testing.assert_allclose(p.numpy(), seq[name].numpy(),
                                   **PARALLEL_VS_SEQUENTIAL)
    assert changed > 0


@pytest.fixture(scope="module")
def device_run(mamba):
    """Capacity 4 (3 clients, an empty slot): round 0's device draw, a
    brand-new client admitted into slot 3, then a device-mode span of
    round 1 over all four.  The port's engine reads the reference's s-law
    table (ROADMAP Limits item 3); the reference's engine takes the same
    admit.  Returns the port's engine, its draws per round (and the span's
    metrics), and the reference's engine and draws per round."""
    cap = N_CLIENTS + 1
    fresh = fed_train.build_fleet(mamba["task"], n_clients=1,
                                  samples=SAMPLES, seed=5)[0]
    jfresh = jfed_train.build_fleet(mamba["jtask"], n_clients=1,
                                    samples=SAMPLES, seed=5)[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_engine, "trace_cdf_row", ref_engine.trace_cdf_row)
        eng = RoundEngine(task=mamba["task"], clients=mamba["clients"],
                          local_epochs=E, batch_size=B, eta0=ETA0,
                          capacity=cap, device="cpu")
        jeng = JRoundEngine(task=mamba["jtask"], clients=mamba["jclients"],
                            local_epochs=E, batch_size=B, eta0=ETA0,
                            capacity=cap)
        key, jkey = prng.prng_key(KEY_SEED), jax.random.PRNGKey(KEY_SEED)
        jdraw = jax.jit(ref_engine.device_sample_round, static_argnums=(4, 5))
        params = {k: v.clone() for k, v in mamba["start"].items()}
        rounds, m = [], None
        for tau, active in ((0, [1, 1, 1, 0]), (1, [1, 1, 1, 1])):
            active = np.asarray(active, np.float32)
            if tau == 1:
                eng.admit(3, fresh)
                jeng.admit(3, jfresh)
                params, m = eng.run_span(params, tau, 1, key=key,
                                         active=active, **_span_kwargs(cap))
            rounds.append((eng.sample_span(key, tau, 1, active),
                           jdraw(jax.random.fold_in(jkey, tau),
                                 jnp.asarray(active), jeng.n, jeng.s_cdf, E,
                                 B)))
    return dict(eng=eng, jeng=jeng, rounds=rounds, metrics=m, params=params,
                fresh=fresh)


def test_device_mode_draws_match_reference(device_run):
    """With the reference's s-law table every alpha and batch index of the
    device draw equals the reference's, before and after an admit, and
    the device-mode span's s is its round's alphas'."""
    for (alpha, idx), (jalpha, jidx) in device_run["rounds"]:
        np.testing.assert_array_equal(alpha[0].numpy(), np.asarray(jalpha))
        np.testing.assert_array_equal(idx[0].numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(device_run["metrics"]["s"][0].numpy(),
                                  np.asarray(jalpha).sum(-1))


def test_admit_lm_client_mid_run(device_run, mamba):
    """A new LM client admitted mid-run lands in its slot's token rows, n
    and s-law as the reference's engine writes them, and the span after
    it trains finite params."""
    eng, jeng = device_run["eng"], device_run["jeng"]
    np.testing.assert_array_equal(eng.data["tokens"].numpy(),
                                  np.asarray(jeng.data["tokens"]))
    np.testing.assert_array_equal(eng.n.numpy(), np.asarray(jeng.n))
    np.testing.assert_array_equal(eng.s_cdf.numpy(), np.asarray(jeng.s_cdf))
    np.testing.assert_array_equal(
        eng.data["tokens"][3, :SAMPLES].numpy(), device_run["fresh"].x)
    for name, p in device_run["params"].items():
        assert torch.isfinite(p).all(), name
    assert any(not torch.equal(p, mamba["start"][name])
               for name, p in device_run["params"].items())


def test_scheduler_churns_an_lm_federation_in_plan_mode(mamba):
    """StreamScheduler over an LMTask in plan mode on the int8 wire (one
    local step a round), in each engine mode from the same params and
    seed: an excluding departure evicts its slot and a brand-new client is
    admitted into a free one (its token rows, n and s-law written), equal
    round records in the two modes, and their params within the
    reference's own check."""
    fresh = fed_train.build_fleet(mamba["task"], n_clients=1,
                                  samples=SAMPLES, seed=7)[0]
    runs = {}
    for mode in ("client_parallel", "client_sequential"):
        sch = StreamScheduler(
            clients=mamba["clients"], task=mamba["task"], engine_mode=mode,
            init_params={k: v.clone() for k, v in mamba["start"].items()},
            capacity=N_CLIENTS + 1, max_samples=SAMPLES, local_epochs=1,
            batch_size=B, eta0=ETA0, compression="int8", mode="plan",
            seed=3, device="cpu",
            events=[Departure(1, client_id=0, policy="exclude"),
                    Arrival(1, client=fresh)])
        sch.run(2)
        eng = sch.engine
        assert eng.compression.name == "int8" and sch.events_applied == 2
        assert sch.history[1].event == "departure-exclude:0;arrival:3;"
        assert 0 not in sch.slot_of and 0 not in sch.objective
        slot = sch.slot_of[N_CLIENTS]
        assert int(eng.n[slot]) == fresh.n
        np.testing.assert_array_equal(eng.data["tokens"][slot].numpy(),
                                      fresh.x)
        runs[mode] = sch
    par, seq = runs["client_parallel"], runs["client_sequential"]
    for a, b in zip(par.history, seq.history, strict=True):
        assert (a.tau, a.eta, a.n_active, a.event) == \
            (b.tau, b.eta, b.n_active, b.event)
        np.testing.assert_array_equal(a.s, b.s)
    for name, p in par.params.items():
        assert torch.isfinite(p).all(), name
        np.testing.assert_allclose(p.numpy(), seq.params[name].numpy(),
                                   **PARALLEL_VS_SEQUENTIAL)


# -- fed_train_step -----------------------------------------------------------

def test_fed_train_step_matches_reference_mamba2(spans, mamba):
    """The port's fed_train_step on reduced mamba2-130m at its config's
    scheme and mode (C, client_parallel) against the reference's (the
    spans fixture's round) on the same params, batches and masks."""
    params = {k: v.clone() for k, v in mamba["start"].items()}
    new, _ = fed_train_step(mamba["task"].loss_fn, mamba["task"].cfg, params,
                            {k: torch.from_numpy(np.asarray(v))
                             for k, v in spans["batches"].items()},
                            torch.from_numpy(spans["plan"][0][0]),
                            np.full(N_CLIENTS, 1 / N_CLIENTS, np.float32),
                            ETA0)
    _close_leaves(new, spans["reference"][2], mamba["start"], E + 1)


def test_fed_train_step_matches_reference_moe():
    """One round through each package's fed_train_step on reduced
    deepseek-v2-lite-16b (MLA + MoE) at its config's scheme and mode (C,
    client_sequential), from the same params (the port's draw)."""
    jcfg, cfg = jget_config(MOE).reduced(), get_config(MOE).reduced()
    jtask, task = JLMTask(jcfg, seq_len=SEQ), LMTask(cfg, seq_len=SEQ)
    jparams = lm_to_numpy(unflatten_tree(task.init_params(0, device="cpu")))
    C = 2
    batch = fed_lm_batches(np.random.default_rng(6), vocab=cfg.vocab,
                           n_clients=C, local_epochs=E, batch=B, seq=SEQ)
    alpha = np.array([[1, 1], [1, 0]], np.float32)
    p = np.full(C, 1 / C, np.float32)
    jnew, _ = jax.jit(functools.partial(jfed_train_step, jtask.loss_fn,
                                        jcfg))(jparams, batch, alpha, p,
                                               jnp.float32(ETA0))
    start = _flat_np(jparams)
    params = {k: v.clone() for k, v in start.items()}
    new, _ = fed_train_step(task.loss_fn, cfg, params,
                            {k: torch.from_numpy(v) for k, v in batch.items()},
                            torch.from_numpy(alpha), p, ETA0)
    _close_leaves(new, _flat_np(jnew), start, E + 1)


# -- launch/steps.py ----------------------------------------------------------

@pytest.fixture(scope="module")
def ref_abstract():
    """The reference's abstract_params, traced once per config (its step
    builders call it again for every shape)."""
    cached = functools.lru_cache(maxsize=None)(jsteps.abstract_params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsteps, "abstract_params", cached)
        yield


def _same_specs(got, want) -> None:
    """A tree of meta tensors against the reference's ShapeDtypeStructs."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same_specs(got[k], want[k])
        return
    assert got.device.type == "meta"
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_steps_match_reference(arch, ref_abstract):
    """param_bytes and serve_fsdp integer-equal to the reference's, and for
    every INPUT_SHAPES entry the step's input specs (shapes, dtypes) and
    meta against the reference's on a (1, 1) smoke mesh."""
    assert sorted(ARCH_IDS) == sorted(JARCH_IDS)
    assert sorted(INPUT_SHAPES) == sorted(JINPUT_SHAPES)
    jcfg, cfg = jget_config(arch), get_config(arch)
    assert steps.param_bytes(cfg) == jsteps.param_bytes(jcfg)
    assert steps.serve_fsdp(cfg) == jsteps.serve_fsdp(jcfg)
    mesh = make_smoke_mesh(1, 1)
    for name, shape in INPUT_SHAPES.items():
        want = jsteps.make_step(jcfg, JINPUT_SHAPES[name], mesh)
        got = steps.make_step(cfg, shape)
        assert got.meta == want.meta, name
        assert len(got.input_specs) == len(want.input_specs), name
        for g, w in zip(got.input_specs, want.input_specs):
            _same_specs(g, w)


def test_train_step_runs_the_round():
    """make_train_step's fn is the federated round through LMTask's loss:
    the reduced config's params move, and two ranks put one client on
    each in client-parallel mode."""
    cfg = get_config("mamba2-130m").reduced()
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=SEQ,
                                global_batch=4)
    bundle = steps.make_train_step(cfg, shape, ranks=2)
    assert bundle.meta == {"clients": 2, "local_epochs": E,
                           "client_batch": 2, "mode": "client_parallel"}
    _, batches, alpha, coeffs, _ = bundle.input_specs
    rng = np.random.default_rng(0)
    params = unflatten_tree(LMTask(cfg, seq_len=SEQ).init_params(
        0, device="cpu"))
    before = {k: v.clone() for k, v in flatten_tree(params).items()}
    out, m = bundle.fn(params, {k: torch.from_numpy(rng.integers(
        0, cfg.vocab, v.shape, dtype=np.int32)) for k, v in batches.items()},
        torch.ones(alpha.shape), torch.full(coeffs.shape, 0.5),
        torch.tensor(ETA0))
    assert out is params
    assert any(not torch.equal(v, before[k])
               for k, v in flatten_tree(out).items())


# -- launch/fed_train.py ------------------------------------------------------

# the reference test's flags (tests/test_fedmodel.py::test_fed_train_cli_smoke)
CLI_FLAGS = ["--arch", "mamba2-130m", "--rounds", "4", "--clients", "2",
             "--seq", "32", "--samples", "8", "--local-epochs", "1",
             "--batch", "2", "--arrive", "1", "--eval-every", "2", "--quiet"]


def test_fed_train_cli_matches_reference(mamba, monkeypatch):
    # the reference's weights through the draw the mamba fixture compiled:
    # no compared field depends on them
    monkeypatch.setattr(JLMTask, "init_params",
                        lambda self, key: jinit(key, self.cfg))
    want = jfed_train.main(CLI_FLAGS)
    got = fed_train.main(CLI_FLAGS + ["--device", "cpu"])
    assert sorted(got) == sorted(want)
    for k in ("arch", "rounds", "events_applied", "capacity", "mode",
              "compression", "params"):
        assert got[k] == want[k], k
    assert got["events_applied"] == 1
    assert np.isfinite(got["final_loss"])


def test_fed_train_refuses_the_mesh_axes():
    """The grid flags as the reference parses them: --model or --pod
    without --data is the reference's error; a sharded client-sequential
    round waits for ROADMAP item 6's next step; --data (with --model or
    --pod) needs an initialised process group."""
    base = ["--device", "cpu", "--rounds", "1", "--quiet"]
    for extra in (["--model", "2"], ["--pod", "2"]):
        with pytest.raises(SystemExit):
            fed_train.main(base + extra)
        with pytest.raises(SystemExit):
            jfed_train.main(base[2:] + extra)
    with pytest.raises(ValueError, match="ROADMAP item 6"):
        fed_train.main(base + ["--data", "1", "--mode", "client_sequential"])
    for extra in (["--data", "1"], ["--data", "1", "--model", "2"],
                  ["--pod", "2", "--data", "1", "--model", "2"]):
        with pytest.raises(RuntimeError, match="process group"):
            fed_train.main(base + extra)


# -- the LM checkpoint across the packages ------------------------------------

def _bits(a) -> np.ndarray:
    """A leaf's raw bits, as the checkpoint stores them."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a



def _moe_cfgs():
    """deepseek-v2-lite reduced, in bf16: its (L, E, d, f) expert leaves
    are 4-D, and its norms stay f32 beside bf16 weights."""
    return (dataclasses.replace(jget_config(MOE).reduced(), dtype="bfloat16"),
            dataclasses.replace(get_config(MOE).reduced(), dtype="bfloat16"))


def test_moe_federation_checkpoint_crosses_packages(tmp_path):
    """The port saves a reduced deepseek-v2-lite federation after a round
    and the reference's load_fed_checkpoint reads its params with equal
    keys, shapes, dtypes and bits; the reference saves one and the port's
    restore(task=LMTask) takes its params bit for bit and runs on."""
    jcfg, cfg = _moe_cfgs()
    jtask, task = JLMTask(jcfg, seq_len=SEQ), LMTask(cfg, seq_len=SEQ)
    jclients = jfed_train.build_fleet(jtask, n_clients=2, samples=4, seed=0)
    clients = fed_train.build_fleet(task, n_clients=2, samples=4, seed=0)
    geometry = dict(capacity=3, max_samples=4, local_epochs=1,
                    batch_size=B, eta0=ETA0)
    sch = StreamScheduler(clients=clients, task=task, device="cpu",
                          init_params=task.init_params(0, device="cpu"),
                          **geometry)
    sch.run(1)
    assert any(v.dim() == 4 for v in sch.params.values())
    sch.save(str(tmp_path / "port"))
    jparams, jstate, _, _, _ = jload_fed_checkpoint(str(tmp_path / "port"))
    jflat = {"/".join(k.key for k in path): leaf for path, leaf in
             jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert list(jflat) == list(sch.params)
    for name, p in sch.params.items():
        want = jflat[name]
        assert tuple(p.shape) == want.shape
        assert str(p.dtype).removeprefix("torch.") == str(want.dtype)
        np.testing.assert_array_equal(_bits(p), _bits(want))
    assert jstate["events_applied"] == 0 and jstate["next_tau"] == 1

    # the other way: the reference's scheduler, from the port's params
    # after the round, saved by the reference and restored by the port
    jsch = JStreamScheduler(
        clients=jclients, task=jtask,
        init_params=jax.tree.map(jnp.asarray, jparams), **geometry)
    jsch.save(str(tmp_path / "ref"))
    back = StreamScheduler.restore(str(tmp_path / "ref"), task=task,
                                   device="cpu")
    assert list(back.params) == list(sch.params)
    for name, p in back.params.items():
        assert p.dtype == sch.params[name].dtype
        np.testing.assert_array_equal(_bits(p), _bits(sch.params[name]))
    back.run(1)
    assert all(torch.isfinite(v.float()).all() for v in back.params.values())
    assert [h.tau for h in back.history] == [0]
