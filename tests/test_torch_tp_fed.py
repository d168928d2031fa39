"""The client-parallel federated LM round over a (pod, data, model) grid
(``fed.sharding.FedSharding(mesh=)``, the engine's model axis,
``launch.fed_train --data/--model/--pod``) against the reference's
single-device ``StreamScheduler``.

4 gloo ranks (``torch.multiprocessing.spawn``, ``file://`` init through
``launch.cluster.init_distributed``; the ranks import no jax) run each
federation twice: as ``--data 2 --model 2`` (clients over data, TP/EP
over model) and as ``--pod 2 --data 1 --model 2`` (clients over the
composite pod x data axis).  The reduced mamba2-130m and
deepseek-v2-lite-16b federations, client-parallel, plan mode, with one
arrival at TAU_ARRIVE, from the same weights in both packages (the
port's draw; ``lm_to_numpy`` for the reference).

Tolerances (``tests/test_torch_fed_train.py``): equal round records (tau,
eta, active count, events, s); after the first span (the rounds before
the arrival, from the same start) each rank's leaf within DELTA_TOL of
the reference delta's norm, the elements at most R (E + 1) ulps apart set
aside where they are at most FLIP_SHARE of the leaf.  Each rank's
``fed_train`` CLI run on both grids ends at the unsharded port run's
probe loss within rtol 1e-4; with ``--compress int8`` (which the
reference refuses with model-sharded params; the port quantizes each
rank's shard of the deltas on a chunk grid of its own, so codes differ
from the unsharded grid's where a chunk straddles a shard) within rtol
INT8_RTOL of the unsharded int8 run's, on the same records."""
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from _tp_common import Row
from repro_torch.configs import get_config
from repro_torch.core.fed_step import flatten_tree, unflatten_tree
from repro_torch.models.params import init_params, shard_params
from repro_torch.params import lm_from_jax, lm_to_numpy

ARCHS = ("mamba2-130m", "deepseek-v2-lite-16b")
LEGS = {"data2-model2": ((2, 2), ("data", "model"), "data"),
        "pod2-data1-model2": ((2, 1, 2), ("pod", "data", "model"),
                              ("pod", "data"))}
N_RANKS = 4
SEQ, SAMPLES, E, B = 16, 6, 2, 2
N_CLIENTS, CAPACITY = 3, 4
ROUNDS, TAU_ARRIVE = 3, 1
ETA0 = 0.1
SEED = 3
DELTA_TOL = 1e-4
FLIP_SHARE = 0.01
CLI = ["--rounds", "2", "--clients", "2", "--seq", "16", "--samples", "4",
       "--local-epochs", "1", "--batch", "2", "--arrive", "1",
       "--eval-every", "2", "--quiet", "--device", "cpu"]
CLI_RTOL = 1e-4
NORM_RTOL = 1e-5
# the probe loss after rounds of int8 deltas on two chunk grids: the
# quantization error of the shards' grid against the whole one's (1.9e-5
# apart at data 2 x model 2 here)
INT8_RTOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(arch):
    return lm_to_numpy(init_params(get_config(arch).reduced(), seed=SEED,
                                   device="cpu"))


def _records(history):
    return [(h.tau, float(h.eta), h.n_active, h.event, np.asarray(h.s))
            for h in history]


@pytest.fixture(scope="module")
def reference():
    """The reference's single-device scheduler per arch: the params after
    the first span and the whole run's records."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.fed import Arrival as JArrival
    from repro.fed import LMTask as JLMTask
    from repro.fed import StreamScheduler as JStreamScheduler
    from repro.launch import fed_train as jfed_train
    out = {}
    for arch in ARCHS:
        task = JLMTask(jget_config(arch).reduced(), seq_len=SEQ)
        clients = jfed_train.build_fleet(task, n_clients=N_CLIENTS,
                                         samples=SAMPLES, seed=0)
        fresh = jfed_train.build_fleet(task, n_clients=1, samples=SAMPLES,
                                       seed=999)[0]
        sch = JStreamScheduler(
            clients=clients, task=task, engine_mode="client_parallel",
            init_params=jax.tree.map(jnp.asarray, _weights(arch)),
            capacity=CAPACITY, max_samples=SAMPLES, local_epochs=E,
            batch_size=B, eta0=ETA0, mode="plan", seed=SEED,
            events=[JArrival(TAU_ARRIVE, client=fresh)])
        sch.run(TAU_ARRIVE, eval_every=ROUNDS)
        first = flatten_tree(lm_from_jax(jax.tree.map(np.asarray,
                                                      sch.params),
                                         device="cpu"))
        sch.run(ROUNDS - TAU_ARRIVE, eval_every=ROUNDS)
        out[arch] = dict(first=first, records=_records(sch.history))
    return out


def _federate(arch, grid=None, axis=None):
    """The port's scheduler, over the grid (None: unsharded), with each
    round's delta norm (``with_metrics``)."""
    from repro_torch.fed import (Arrival, FedSharding, LMTask,
                                 StreamScheduler)
    from repro_torch.launch import fed_train
    cfg = get_config(arch).reduced()
    task = LMTask(cfg, seq_len=SEQ, fsdp=False)
    params = flatten_tree(lm_from_jax(_weights(arch), device="cpu"))
    fs = None
    if grid is not None:
        fs = FedSharding(mesh=grid, axis=axis)
        params = fs.put_params(params, task.param_specs(params), cfg=cfg)
    sch = StreamScheduler(
        clients=fed_train.build_fleet(task, n_clients=N_CLIENTS,
                                      samples=SAMPLES, seed=0),
        task=task, engine_mode="client_parallel", init_params=params,
        capacity=CAPACITY, max_samples=SAMPLES, local_epochs=E,
        batch_size=B, eta0=ETA0, mode="plan", seed=SEED, device="cpu",
        sharding=fs, with_metrics=True,
        events=[Arrival(TAU_ARRIVE, client=fed_train.build_fleet(
            task, n_clients=1, samples=SAMPLES, seed=999)[0])])
    sch.run(TAU_ARRIVE, eval_every=ROUNDS)
    first = {k: v.clone() for k, v in sch.params.items()}
    sch.run(ROUNDS - TAU_ARRIVE, eval_every=ROUNDS)
    return dict(first=first, records=_records(sch.history),
                slots=list(sch.engine.local_slots),
                delta_norms=list(sch.delta_norms))


def _rank_main(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    from repro_torch.launch import fed_train
    from repro_torch.launch.cluster import init_distributed
    from repro_torch.launch.mesh import make_grid
    dist = init_distributed(f"file://{init_file}", world, rank,
                            backend="gloo")
    try:
        out = {}
        for leg, (shape, names, axis) in LEGS.items():
            grid = make_grid(shape, names)
            out[leg] = {"model": grid.coord("model"),
                        "fed": grid.coord(axis)}
            for arch in ARCHS:
                out[leg][arch] = _federate(arch, grid, axis)
            flags = [x for n, v in zip(names, shape)
                     for x in (f"--{n}", str(v))]
            out[leg]["cli"] = fed_train.main(CLI + flags)
            out[leg]["cli_int8"] = fed_train.main(
                CLI + flags + ["--compress", "int8"])
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tpfed")
    mp.spawn(_rank_main, nprocs=N_RANKS, join=True,
             args=(N_RANKS, str(tmp / "pg"), str(tmp)))
    out = []
    for r in range(N_RANKS):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _same_records(got, want):
    assert len(got) == len(want) == ROUNDS
    for g, w in zip(got, want):
        assert g[:4] == w[:4]
        np.testing.assert_array_equal(g[4], w[4])


def _close_leaves(got, want, start, ulps):
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        w = want[name]
        diff = p - w
        top = torch.maximum(p.abs(), w.abs())
        flips = (diff != 0) & (diff.abs() <= ulps * (
            torch.nextafter(top, torch.tensor(float("inf"))) - top))
        if flips.float().mean().item() <= FLIP_SHARE:
            diff = diff.masked_fill(flips, 0.0)
        norm = (w - start[name]).norm().item()
        assert diff.norm().item() <= DELTA_TOL * norm, \
            (name, diff.norm().item(), norm)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("leg", sorted(LEGS))
def test_round_records_match_the_single_device_reference(ranks, reference,
                                                         leg, arch):
    for out in ranks:
        _same_records(out[leg][arch]["records"], reference[arch]["records"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("leg", sorted(LEGS))
def test_first_span_leaves_match_the_single_device_reference(
        ranks, reference, leg, arch):
    """Each rank's shards after the first span against the reference's
    params cut as that rank's: every leaf stays sharded over model."""
    cfg = get_config(arch).reduced()
    start = flatten_tree(lm_from_jax(_weights(arch), device="cpu"))
    for out in ranks:
        row = Row(2, out[leg]["model"])
        cut = lambda t: flatten_tree(shard_params(unflatten_tree(t), cfg,
                                                  row))
        got = out[leg][arch]["first"]
        _close_leaves(got, cut(reference[arch]["first"]), cut(start),
                      TAU_ARRIVE * (E + 1))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("leg", sorted(LEGS))
def test_delta_norms_count_each_shard_once(ranks, leg, arch):
    """Each round's delta norm over the grid (the model axis's shards
    summed once each, replicated leaves and copies counted once) against
    the unsharded port's, every element in another summation order."""
    want = _federate(arch)["delta_norms"]
    assert len(want) == ROUNDS
    for out in ranks:
        np.testing.assert_allclose(out[leg][arch]["delta_norms"], want,
                                   rtol=NORM_RTOL)


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_each_federation_rank_owns_its_slots(ranks, leg):
    for out in ranks:
        fed = out[leg]["fed"]
        assert out[leg][ARCHS[0]]["slots"] == [2 * fed, 2 * fed + 1]


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_fed_train_cli_on_the_grid_matches_the_unsharded_port(ranks, leg):
    from repro_torch.launch import fed_train
    want = fed_train.main(CLI)
    for out in ranks:
        got = out[leg]["cli"]
        for k in ("arch", "rounds", "events_applied", "capacity", "mode",
                  "params"):
            assert got[k] == want[k], k
        np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                                   rtol=CLI_RTOL)


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_fed_train_int8_on_the_grid_reduces_each_shard(ranks, leg):
    from repro_torch.launch import fed_train
    want = fed_train.main(CLI + ["--compress", "int8"])
    for out in ranks:
        got = out[leg]["cli_int8"]
        assert got["compression"] == want["compression"] == "int8"
        for k in ("rounds", "events_applied", "capacity", "params"):
            assert got[k] == want[k], k
        np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                                   rtol=INT8_RTOL)
