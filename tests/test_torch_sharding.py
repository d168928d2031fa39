"""The port's sharded federation axis (``repro_torch.fed.sharding``) against
the reference's single-device run.

The multi-rank cases start 4 CPU ranks on gloo once for the module
(``torch.multiprocessing.spawn``, a ``file://`` init); each rank runs
every case and writes its results, which the tests below read.  A rank
that raises fails the spawn, and with it every test that reads the ranks.
The ranks import nothing of JAX: the reference runs in this process.

- ``FedSharding``: whole slots per rank (``pad_capacity``), the ragged
  client-axis guard (the reference's "not divisible" message), and
  ``make_fed_sharding`` refusing to run without a process group.
- Both sharded kernels' plain paths at the reference's K 64, D 600 against
  the single-rank wrapper and the reference's Pallas kernel (interpret
  mode), within the reference's 1e-4 (``tests/_sharded_check.py:74``).
- The reference's sharded scenario (``tests/_sharded_check.py:43-60``:
  SYNTHETIC_LR, 6 clients, capacity 7 padded to 8, a newcomer at tau 3,
  client 2 departing at tau 6), 12 rounds at 4 ranks, ``agg="flat"`` and
  ``"tree"`` under scheme C and ``"flat"`` under scheme A (which normalises
  over every slot, so a share cut before the coefficients would show):
  free-running against the reference's single-device run at
  the reference's sharded gate (rtol 3e-3, atol 3e-5, equal ``s`` with the
  padded slot at 0, equal events), and teacher-forced (each round started
  from the reference's params) within PARAM_TOL.
- The CNN at full width on the int8 and int8-topk wires at 4 ranks: each
  rank's payload and scales are its rows of the unsharded wire bit for
  bit, and the all-reduced update lies within the f32 summation bound of
  the unsharded one (``_summation_bound``).
- World size 1 is bit-identical to the unsharded trainer, flat and tree,
  f32 and int8.
- The same scenario drawn on the device (``mode="device"``, capacity 8 on
  every side, the reference's s-law table): at 4 ranks the round records
  equal the unsharded port run's and the reference's bit for bit (every
  rank draws the whole capacity, then cuts its share), and each round,
  started from the reference's params, lands within PARAM_TOL of the
  reference's single-device round.
"""
import datetime
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs.paper import EMNIST_CNN as PORT_CNN
from repro_torch.configs.paper import SYNTHETIC_LR as PORT_LR
from repro_torch.core.aggregation import (aggregate_deltas_compressed_ref,
                                          aggregate_deltas_flat,
                                          flatten_for_wire)
from repro_torch.core.compression import compress_flat, resolve_compression
from repro_torch.core.participation import TRACES as PORT_TRACES
from repro_torch.fed import (Arrival, Client, Departure, FederatedTrainer,
                             FedSharding, RoundEngine, StreamScheduler,
                             make_fed_sharding)
from repro_torch.kernels import ops
from repro_torch.models.small import init_small as port_init_small
from repro_torch.models.small import make_loss_fn as port_loss_fn
from repro_torch.params import from_jax, to_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside the other test workers, a pool of
    threads per process oversubscribes the cores, and its idle threads
    spin, slowing every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_RANKS = 4
ROUNDS = 12
CAPACITY = 7                    # padded to 8 over 4 ranks
# the reference's gate for its sharded engine against the single-device
# one (tests/_sharded_check.py:82-98)
SHARDED_GATE = dict(rtol=3e-3, atol=3e-5)
# one round of the port against the reference's, from the same params
# (tests/test_torch_trainer.py's PARAM_TOL)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
AGGS = ("flat", "tree")
# the scenario's cases: (agg, scheme)
SCENARIOS = {"flat": ("flat", "C"), "tree": ("tree", "C"),
             "flat-A": ("flat", "A")}
WIRES = ("int8", "int8-topk")
CNN_CLIENTS = 8                 # 2 per rank
# the device-mode case: (agg, scheme), drawn over the padded capacity, so
# the unsharded runs draw over the same slots as the ranks
DEVICE_CASE = ("flat", "C")
DEVICE_CAPACITY = 8
U = 2.0 ** -24                  # f32 unit roundoff


# -- inputs: the reference scenario's data, made in this process --------------

def _client_arrays(n, seed):
    from repro.data import synthetic_federation
    train, test = synthetic_federation(0.5, 0.5, n, seed=seed)
    rng = np.random.default_rng(seed)
    return [dict(x=tr[0], y=tr[1], trace=int(rng.integers(0, 8)),
                 x_test=te[0], y_test=te[1]) for tr, te in zip(train, test)]


@pytest.fixture(scope="module")
def inputs():
    """tests/_sharded_check.py's make_clients() and newcomer, as arrays,
    and the reference's initial params."""
    import jax
    from repro.configs.paper import SYNTHETIC_LR
    from repro.core.participation import TRACES
    from repro.fed.engine import trace_cdf_row
    from repro.models.small import init_small
    return dict(
        clients=_client_arrays(6, 0), newcomer=_client_arrays(1, 99)[0],
        init={k: np.asarray(v) for k, v in
              init_small(jax.random.PRNGKey(0), SYNTHETIC_LR).items()},
        cdf_rows={t.name: trace_cdf_row(t, 5) for t in TRACES})


def _reference_table(rows):
    """The port's trace_cdf_row giving the reference's rows (E = 5): the
    two tables differ by up to 2e-6 (tests/test_torch_device_mode.py)."""
    return lambda trace, E: rows[trace.name]


def _port_client(a, **kw):
    return Client(x=a["x"], y=a["y"], trace=PORT_TRACES[a["trace"]],
                  x_test=a["x_test"], y_test=a["y_test"], **kw)


# -- the reference's single-device run ----------------------------------------

@pytest.fixture(scope="module")
def reference(inputs):
    """The reference's StreamScheduler in plan mode on one device, one
    round at a time: {case: (params after each round, history)}."""
    import jax.numpy as jnp
    from repro.configs.paper import SYNTHETIC_LR
    from repro.core.participation import TRACES
    from repro.fed import Arrival as RefArrival
    from repro.fed import Client as RefClient
    from repro.fed import Departure as RefDeparture
    from repro.fed import StreamScheduler as RefScheduler
    from repro.models.small import make_loss_fn

    def client(a):
        return RefClient(x=a["x"], y=a["y"], trace=TRACES[a["trace"]],
                         x_test=a["x_test"], y_test=a["y_test"])

    out = {}
    cases = {case: (agg, scheme, "plan", CAPACITY)
             for case, (agg, scheme) in SCENARIOS.items()}
    cases["device"] = DEVICE_CASE + ("device", DEVICE_CAPACITY)
    for case, (agg, scheme, mode, capacity) in cases.items():
        sch = RefScheduler(
            clients=[client(a) for a in inputs["clients"]],
            init_params={k: jnp.asarray(v) for k, v in inputs["init"].items()},
            loss_fn=make_loss_fn(SYNTHETIC_LR), capacity=capacity,
            max_samples=60, local_epochs=5, batch_size=10, scheme=scheme,
            eta0=0.5, seed=0, mode=mode, agg=agg, interpret=True,
            events=[RefArrival(3, client=client(inputs["newcomer"])),
                    RefDeparture(6, client_id=2, policy="exclude")])
        params = [inputs["init"]]
        for _ in range(ROUNDS):
            sch.run(1, eval_every=4)
            params.append({k: np.asarray(v) for k, v in sch.params.items()})
        out[case] = (params, sch.history)
    return out


# -- the ranks ----------------------------------------------------------------

def _kernel_inputs():
    """The reference's K 64, D 600 (tests/_sharded_check.py:68-70), drawn
    with numpy: uniform coeffs, normal deltas, and their int8 wire."""
    rng = np.random.default_rng(0)
    c = torch.from_numpy(rng.uniform(size=64).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(64, 600)).astype(np.float32))
    payload, scales = compress_flat(d, resolve_compression("int8:chunk=100"))
    return c, d, payload, scales


def _kernels(fs):
    c, d, payload, scales = _kernel_inputs()
    local = dict(c=fs.shard(c), d=fs.shard(d))
    return dict(
        f32=ops.weighted_agg_sharded(local["c"], local["d"], sharding=fs),
        bf16=ops.weighted_agg_sharded(local["c"], fs.shard(
            d.to(torch.bfloat16)), sharding=fs),
        int8=ops.weighted_agg_quant_sharded(
            local["c"], fs.shard(payload), fs.shard(scales), chunk=100,
            sharding=fs))


def _scenario(fs, inputs, case, teacher=None):
    """The reference scenario on the port's StreamScheduler, sharded by
    ``fs``; with ``teacher`` (params before each round), every round
    starts from those params.  Case "device" draws on the device."""
    if case == "device":
        (agg, scheme), mode, capacity = DEVICE_CASE, "device", \
            DEVICE_CAPACITY
    else:
        (agg, scheme), mode, capacity = SCENARIOS[case], "plan", CAPACITY
    clients = [_port_client(a) for a in inputs["clients"]]
    engine = RoundEngine(
        loss_fn=port_loss_fn(PORT_LR), clients=clients, local_epochs=5,
        batch_size=10, scheme=scheme, eta0=0.5, agg=agg, capacity=capacity,
        max_samples=60, device="cpu", sharding=fs)
    sch = StreamScheduler(
        clients=clients, init_params=from_jax(inputs["init"], PORT_LR, "cpu"),
        engine=engine, mode=mode, seed=0,
        events=[Arrival(3, client=_port_client(inputs["newcomer"])),
                Departure(6, client_id=2, policy="exclude")])
    params = []
    for r in range(ROUNDS):
        if teacher is not None:
            sch.params = from_jax(teacher[r], PORT_LR, "cpu")
        sch.run(1, eval_every=4)
        # copies: the next round updates the params in place
        params.append({k: v.copy()
                       for k, v in to_numpy(sch.params, PORT_LR).items()})
    return dict(params=params, capacity=engine.capacity,
                rows=engine.data["x"].numpy().copy(),
                history=[(h.tau, h.eta, h.n_active, h.event, h.s)
                         for h in sch.history])


def _cnn_deltas():
    """Full-width CNN params and CNN_CLIENTS clients' deltas drawn with
    numpy (client 5's all zero: a client that did no work), coeffs."""
    params = port_init_small(PORT_CNN, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    deltas = {k: torch.from_numpy((1e-3 * rng.normal(
        size=(CNN_CLIENTS, *v.shape))).astype(np.float32))
        for k, v in sorted(params.items())}
    for v in deltas.values():
        v[5] = 0.0
    coeffs = torch.from_numpy(rng.uniform(size=CNN_CLIENTS).astype(np.float32))
    return params, deltas, coeffs


def _flat(params):
    return torch.cat([params[k].reshape(-1) for k in sorted(params)])


def _wires(fs):
    """Each wire's payload and scales from this rank's clients, and the
    all-reduced update on both layouts."""
    params, deltas, coeffs = _cnn_deltas()
    local = {k: fs.shard(v) for k, v in deltas.items()}
    out = {}
    for wire in WIRES:
        spec = resolve_compression(wire)
        payload, scales = compress_flat(
            flatten_for_wire(params, local, spec, PORT_CNN.kind)[0], spec)
        updated = {}
        for agg, fn in (("flat", aggregate_deltas_flat),
                        ("tree", aggregate_deltas_compressed_ref)):
            new = fn({k: v.clone() for k, v in params.items()}, local,
                     fs.shard(coeffs), compression=spec,
                     model_kind=PORT_CNN.kind, sharding=fs)
            updated[agg] = _flat(new)
        out[wire] = dict(payload=payload.contiguous(), scales=scales,
                         updated=updated)
    return out


def _rank_main(rank, world, init_file, out_dir, inputs, teachers):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from repro_torch.fed import engine
        engine.trace_cdf_row = _reference_table(inputs["cdf_rows"])
        fs = make_fed_sharding()
        out = dict(n_shards=fs.n_shards, rank=fs.rank,
                   slots=fs.slots(fs.pad_capacity(CAPACITY)),
                   kernels=_kernels(fs), wires=_wires(fs))
        for case in SCENARIOS:
            out[case] = _scenario(fs, inputs, case)
            out[case + "-teacher"] = _scenario(fs, inputs, case,
                                               teachers[case])
        out["device"] = _scenario(fs, inputs, "device", teachers["device"])
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(inputs, reference, tmp_path_factory):
    """Start the 4 gloo ranks once; their results, by rank."""
    tmp = tmp_path_factory.mktemp("ranks")
    teachers = {case: reference[case][0]
                for case in (*SCENARIOS, "device")}
    mp.spawn(_rank_main, nprocs=N_RANKS, join=True,
             args=(N_RANKS, str(tmp / "pg"), str(tmp), inputs, teachers))
    out = []
    for r in range(N_RANKS):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# -- FedSharding --------------------------------------------------------------

def test_pad_capacity_gives_whole_slots_per_shard():
    fs = FedSharding(n_shards=4, rank=1)
    assert [fs.pad_capacity(c) for c in (1, 4, 6, 7, 9)] == [4, 4, 8, 8, 12]
    assert fs.slots(8) == range(2, 4)
    assert FedSharding(n_shards=1, rank=0).pad_capacity(7) == 7
    with pytest.raises(ValueError, match="rank 4"):
        FedSharding(n_shards=4, rank=4)


def test_make_fed_sharding_raises_without_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_fed_sharding()


def test_ragged_client_axis_raises_not_divisible():
    fs = FedSharding(n_shards=2, rank=0)
    with pytest.raises(ValueError, match="not divisible.*pad the client axis"):
        fs.shard(torch.ones(3, 8))
    with pytest.raises(ValueError, match="not divisible"):
        fs.slots(7)
    assert torch.equal(fs.shard(torch.arange(8.0).reshape(4, 2)),
                       torch.tensor([[0.0, 1.0], [2.0, 3.0]]))


def test_host_engine_refuses_sharding(inputs):
    with pytest.raises(ValueError, match="host engine is not sharded"):
        FederatedTrainer(
            loss_fn=port_loss_fn(PORT_LR),
            init_params=port_init_small(PORT_LR, device="cpu"),
            clients=[_port_client(a) for a in inputs["clients"]],
            engine="host", device="cpu",
            sharding=FedSharding(n_shards=1, rank=0))


# -- both sharded kernels at 4 ranks ------------------------------------------

@pytest.mark.parametrize("case", ["f32", "bf16", "int8"])
def test_sharded_kernels_match_the_single_rank_kernel(ranks, case):
    """Tolerance: the reference's 1e-4 max abs error of its psum epilogue
    against the single-device reduction (ops.TOLERANCE)."""
    import jax.numpy as jnp
    from repro.kernels import ops as ref_ops
    c, d, payload, scales = _kernel_inputs()
    if case == "int8":
        tol = ops.TOLERANCE["weighted_agg_quant_sharded"][torch.int8]
        want = ops.weighted_agg_quant(c, payload, scales, chunk=100)
        pallas = ref_ops.weighted_agg_quant(
            jnp.asarray(c.numpy()), jnp.asarray(payload.contiguous().numpy()),
            jnp.asarray(scales.numpy()), chunk=100, interpret=True)
    else:
        dtype = torch.float32 if case == "f32" else torch.bfloat16
        tol = ops.TOLERANCE["weighted_agg_sharded"][dtype]
        want = ops.weighted_agg(c, d.to(dtype))
        pallas = ref_ops.weighted_agg(jnp.asarray(c.numpy()), jnp.asarray(
            d.to(dtype).float().numpy()), interpret=True)
    for r in ranks:
        got = r["kernels"][case]
        torch.testing.assert_close(got, want, **tol)
        torch.testing.assert_close(got, torch.tensor(np.asarray(pallas)),
                                   **tol)
        assert torch.equal(got, ranks[0]["kernels"][case])   # replicated


# -- the reference's sharded scenario at 4 ranks ------------------------------

def test_ranks_own_whole_slots_and_only_their_rows(ranks, inputs):
    """Capacity 7 -> 8: rank r holds slots 2r, 2r+1 and only their rows;
    the newcomer (slot 6) went to rank 3 alone."""
    nmax = ranks[0]["flat"]["rows"].shape[1]
    rows = [np.pad(a["x"], ((0, nmax - len(a["x"])), (0, 0)))
            for a in inputs["clients"] + [inputs["newcomer"]]]
    rows.append(np.zeros_like(rows[0]))                # slot 7: padding
    for r in ranks:
        assert (r["n_shards"], r["slots"]) == (N_RANKS,
                                               range(2 * r["rank"],
                                                     2 * r["rank"] + 2))
        for case in SCENARIOS:
            assert r[case]["capacity"] == 8
            np.testing.assert_array_equal(
                r[case]["rows"], np.stack([rows[s] for s in r["slots"]]))


@pytest.mark.parametrize("case", SCENARIOS)
def test_four_ranks_match_the_single_device_reference(ranks, reference,
                                                      case):
    """12 free-running rounds at the reference's sharded gate, every round;
    equal s (the padded slot at 0), eta, n_active and events."""
    want_params, want_history = reference[case]
    got = ranks[0][case]
    assert len(got["history"]) == len(want_history) == ROUNDS
    events = []
    for (tau, eta, n_active, event, s), w in zip(got["history"],
                                                 want_history):
        assert (tau, eta, n_active, event) == (w.tau, w.eta, w.n_active,
                                               w.event)
        np.testing.assert_array_equal(s[:CAPACITY], np.asarray(w.s))
        assert (s[CAPACITY:] == 0).all()
        events.append(event)
    assert events[3] == "arrival:6;" and events[6] == "departure-exclude:2;"
    for r, (g, w) in enumerate(zip(got["params"], want_params[1:])):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=f"{k} round {r}",
                                       **SHARDED_GATE)
    for other in ranks[1:]:              # the params are replicated
        for g, o in zip(got["params"], other[case]["params"]):
            for k in g:
                np.testing.assert_array_equal(g[k], o[k])


@pytest.mark.parametrize("case", SCENARIOS)
def test_four_ranks_teacher_forced_within_param_tol(ranks, reference, case):
    """Each round started from the reference's params: the 4-rank round
    lands within PARAM_TOL of the reference's round."""
    want_params = reference[case][0]
    for r, (g, w) in enumerate(zip(ranks[0][case + "-teacher"]["params"],
                                   want_params[1:])):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=f"{k} round {r}",
                                       **PARAM_TOL)


def test_four_ranks_device_mode_draw_the_unsharded_rounds(ranks, reference,
                                                         inputs, monkeypatch):
    """Device mode at 4 ranks: the round records bit-identical to the
    unsharded port run's and to the reference's, on every rank; each
    round, started from the reference's params, within PARAM_TOL of the
    reference's single-device round."""
    from repro_torch.fed import engine
    monkeypatch.setattr(engine, "trace_cdf_row",
                        _reference_table(inputs["cdf_rows"]))
    want_params, want_history = reference["device"]
    plain = _scenario(None, inputs, "device", want_params)
    assert plain["capacity"] == DEVICE_CAPACITY
    for (tau, eta, n_active, event, s), w in zip(plain["history"],
                                                 want_history, strict=True):
        assert (tau, eta, n_active, event) == (w.tau, w.eta, w.n_active,
                                               w.event)
        np.testing.assert_array_equal(s, np.asarray(w.s))
    assert "".join(h[3] for h in plain["history"]) == \
        "arrival:6;departure-exclude:2;"
    for r in ranks:
        got = r["device"]
        for a, b in zip(got["history"], plain["history"], strict=True):
            assert a[:4] == b[:4]
            np.testing.assert_array_equal(a[4], b[4])
        for i, (g, w) in enumerate(zip(got["params"], want_params[1:])):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], err_msg=f"{k} {i}",
                                           **PARAM_TOL)


# -- the CNN's int8 wires at 4 ranks ------------------------------------------

@pytest.mark.parametrize("wire", WIRES)
def test_each_ranks_wire_is_its_rows_of_the_unsharded_wire(ranks, wire):
    params, deltas, _ = _cnn_deltas()
    spec = resolve_compression(wire)
    payload, scales = compress_flat(
        flatten_for_wire(params, deltas, spec, PORT_CNN.kind)[0], spec)
    per = CNN_CLIENTS // N_RANKS
    for r in ranks:
        rows = slice(r["rank"] * per, (r["rank"] + 1) * per)
        got = r["wires"][wire]
        assert torch.equal(got["payload"], payload[rows])
        assert torch.equal(got["scales"].view(torch.int32),
                           scales[rows].view(torch.int32))


def _summation_bound(coeffs, payload, scales, chunk, inverse, new):
    """Two sums of the same K products in different orders differ by at
    most 2 K u sum_k |c_k q_kd| (each within K u of the exact sum, u =
    2^-24), and rounding params + update adds at most 2 u |new| more.  The
    sums lie in the wire's order, ``new`` in the port's."""
    K = len(coeffs)
    q = (payload.double().reshape(K, -1, chunk)
         * scales.double()[..., None]).reshape(K, -1)[:, :len(inverse)]
    a = (coeffs.double().abs() @ q.abs())[inverse]
    return 2 * K * U * a + 2 * U * new.double().abs()


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("wire", WIRES)
def test_all_reduced_update_within_the_f32_summation_bound(ranks, wire, agg):
    params, deltas, coeffs = _cnn_deltas()
    spec = resolve_compression(wire)
    flat, inverse = flatten_for_wire(params, deltas, spec, PORT_CNN.kind)
    payload, scales = compress_flat(flat, spec)
    fn = aggregate_deltas_flat if agg == "flat" else \
        aggregate_deltas_compressed_ref
    want = _flat(fn({k: v.clone() for k, v in params.items()}, deltas,
                    coeffs, compression=spec, model_kind=PORT_CNN.kind))
    bound = _summation_bound(coeffs, payload, scales, spec.chunk, inverse,
                             want)
    for r in ranks:
        got = r["wires"][wire]["updated"][agg]
        assert torch.equal(got, ranks[0]["wires"][wire]["updated"][agg])
        diff = (got.double() - want.double()).abs()
        assert bool((diff <= bound).all()), float((diff - bound).max())
    assert not torch.equal(want, _flat(params))          # the update moved


# -- world size 1 -------------------------------------------------------------

@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        yield make_fed_sharding()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("compression", [None, "int8"])
@pytest.mark.parametrize("agg", AGGS)
def test_one_rank_is_bit_identical_to_unsharded(one_rank, inputs, agg,
                                                compression):
    """A one-rank all-reduce is the identity and the local reduction is
    the unsharded one: equal params and round records, bit for bit."""
    def trainer(sharding):
        clients = [_port_client(a) for a in inputs["clients"]]
        clients[-1].active_from = 2
        clients[1].departs_at = 3
        return FederatedTrainer(
            loss_fn=port_loss_fn(PORT_LR),
            init_params=from_jax(inputs["init"], PORT_LR, "cpu"),
            clients=clients, local_epochs=5, batch_size=10, scheme="C",
            eta0=0.5, seed=0, engine="plan", agg=agg,
            compression=compression, device="cpu", sharding=sharding)

    plain, sharded = trainer(None), trainer(one_rank)
    plain.run(6, eval_every=2)
    sharded.run(6, eval_every=2)
    assert sharded._scheduler.engine.sharding is one_rank
    assert "".join(h.event for h in sharded.history) == \
        "arrival:5;departure-exclude:1;"
    for a, b in zip(plain.history, sharded.history, strict=True):
        assert (a.tau, a.eta, a.n_active, a.event) == \
            (b.tau, b.eta, b.n_active, b.event)
        np.testing.assert_array_equal(a.s, b.s)
    for k, v in plain.params.items():
        assert torch.equal(v, sharded.params[k]), k
