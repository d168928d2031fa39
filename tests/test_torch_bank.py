"""The port's tiered client bank and cohort prefetch (``fed/bank.py``,
``StreamScheduler(bank=, prefetch=)``, ``FedState.upcoming_arrivals``)
against the reference's, and the boundary's flush on a raising event.

- ``pad_rows`` byte for byte the reference's; ``ClientBank``'s put,
  idempotence, stats, LRU spill and reload, the budget-needs-spill_dir
  refusal, and a spill file of either package read by the other.
- ``upcoming_arrivals`` the reference's on the same queues, the
  evict-and-rejoin-in-one-boundary case included.
- The ports of ``tests/test_bank.py``: bank+prefetch bit-identical to the
  resident scheduler (flash-crowd and diurnal, client-parallel and
  client-sequential); the rotation fleet beyond capacity against the same
  schedule all resident; the rejoin within a staged cohort; a TraceShift
  after staging; a stager failure falling back to a synchronous admit;
  supersede and close; churn with no miss; the chunked (v2) checkpoint.
- One cross-package leg: rotation and flash-crowd cut short as in
  ``tests/test_torch_scenarios.py``, the port's prefetching scheduler
  against the reference's, teacher-forced one round at a time (records
  equal, each round's params within PARAM_TOL, the same hits and misses).
- The repair: after an event raises mid-boundary, the admits already
  recorded are in the port's engine as in the reference's.

The port runs on the CPU here, where the stager has no CUDA stream: the
stacks are numpy arrays, as on the admit path.
"""
import threading

import numpy as np
import pytest
import torch

import repro_torch.fed.engine as port_engine
import repro_torch.fed.stream as port_stream
from repro_torch.checkpoint import CorruptCheckpointError
from repro_torch.configs.paper import SYNTHETIC_LR as CFG
from repro_torch.core.participation import TRACES
from repro_torch.data import synthetic_federation
from repro_torch.fed import (Arrival, Client, Departure, FedState,
                             StreamScheduler)
from repro_torch.fed import scenarios as P
from repro_torch.fed.bank import ClientBank, CohortStager, pad_rows
from repro_torch.fed.engine import trace_cdf_row
from repro_torch.fed.scenarios import build_scheduler, make_scenario
from repro_torch.models.small import init_small, make_loss_fn
from repro_torch.params import from_jax, to_numpy
from test_torch_scenarios import (EVAL_EVERY, PARAM_TOL, SHORT, SHORT_ETA0,
                                  assert_records_equal)

NO_EVAL = 10 ** 9
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: a span here is thousands of tiny CPU ops, which
    a pool of threads per test worker, beside the other workers, only slows
    down (40x at 4 workers of 8 threads on 8 cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_clients(n=8, seed=0, trace_idx=None, pkg=None):
    """tests/test_bank.py's clients, of the port (or of ``pkg``, the
    reference's fed package): the same arrays and traces either way."""
    if pkg is None:
        client, traces, fed = Client, TRACES, synthetic_federation
    else:
        from repro.core.participation import TRACES as traces
        from repro.data import synthetic_federation as fed
        client = pkg.Client
    train, test = fed(0.5, 0.5, n, seed=seed)
    rng = np.random.default_rng(seed)
    return [client(x=tr[0], y=tr[1],
                   trace=traces[trace_idx if trace_idx is not None
                                else rng.integers(0, 8)],
                   x_test=te[0], y_test=te[1])
            for tr, te in zip(train, test)]


def make_scheduler(clients, *, capacity=None, mode="device", seed=0,
                   events=(), **kw):
    return StreamScheduler(
        clients=clients, init_params=init_small(CFG, seed=0, device="cpu"),
        loss_fn=make_loss_fn(CFG), capacity=capacity, local_epochs=5,
        batch_size=6, scheme="C", eta0=1.0, seed=seed, mode=mode,
        events=events, device="cpu", model_kind=CFG.kind, **kw)


def assert_history_identical(h1, h2):
    assert len(h1) == len(h2)
    for r1, r2 in zip(h1, h2):
        assert r1.tau == r2.tau and r1.event == r2.event
        assert r1.eta == r2.eta and r1.n_active == r2.n_active
        np.testing.assert_array_equal(np.asarray(r1.s), np.asarray(r2.s))
        # rounds without an eval are NaN on both sides
        np.testing.assert_array_equal(r1.loss, r2.loss)
        np.testing.assert_array_equal(r1.acc, r2.acc)


def assert_params_bitwise(p1, p2):
    assert p1.keys() == p2.keys()
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k


def ref_task():
    from repro.configs.paper import SYNTHETIC_LR as RCFG
    from repro.fed.task import ArrayTask
    from repro.models.small import make_loss_fn as rloss
    return ArrayTask(rloss(RCFG), tuple(RCFG.input_shape))


def port_task():
    from repro_torch.fed.task import ArrayTask
    return ArrayTask(make_loss_fn(CFG), tuple(CFG.input_shape))


# -- pad_rows and ClientBank --------------------------------------------------

def test_pad_rows_equals_the_reference_byte_for_byte():
    import repro.fed as ref_fed
    from repro.fed.bank import pad_rows as ref_pad_rows
    ours = make_clients(5, seed=4)
    theirs = make_clients(5, seed=4, pkg=ref_fed)
    nmax = max(c.n for c in ours) + 3
    for a, b in zip(ours, theirs):
        got = pad_rows(port_task(), nmax, a)
        want = ref_pad_rows(ref_task(), nmax, b)
        assert got.keys() == want.keys()
        for name in want:
            assert got[name].dtype == want[name].dtype
            assert got[name].tobytes() == want[name].tobytes(), name
    with pytest.raises(ValueError, match="max_samples"):
        pad_rows(port_task(), ours[0].n - 1, ours[0])
    from repro_torch.fed.task import ArrayTask
    with pytest.raises(ValueError, match="feature shape"):
        pad_rows(ArrayTask(make_loss_fn(CFG), (CFG.input_shape[0] + 1,)),
                 nmax, ours[0])


def test_bank_put_rows_roundtrip_and_idempotence():
    sch = make_scheduler(make_clients(3, seed=1), capacity=3)
    bank = ClientBank(sch.engine.task, sch.engine.nmax)
    c = sch.clients[0]
    assert bank.put(0, c) and 0 in bank and len(bank) == 1
    rows = bank.rows(0)
    expect = pad_rows(sch.engine.task, sch.engine.nmax, c)
    assert set(rows) == set(expect)
    for name in rows:
        np.testing.assert_array_equal(rows[name], expect[name])
        assert rows[name].shape[0] == sch.engine.nmax
    puts = bank.puts
    assert not bank.put(0, c)            # idempotent: no re-pad
    assert bank.puts == puts
    st = bank.stats()
    assert st["clients"] == 1 and st["resident"] == 1
    assert st["row_nbytes"] > 0
    assert st["resident_bytes"] == st["row_nbytes"] == bank.resident_bytes


def test_bank_spills_lru_to_disk_and_reloads(tmp_path):
    sch = make_scheduler(make_clients(4, seed=2), capacity=4)
    row_nbytes = ClientBank(sch.engine.task, sch.engine.nmax).row_nbytes
    bank = ClientBank(sch.engine.task, sch.engine.nmax,
                      spill_dir=str(tmp_path),
                      ram_budget_bytes=2 * row_nbytes)
    for i, c in enumerate(sch.clients):
        bank.put(i, c)
    st = bank.stats()
    assert st["clients"] == 4
    assert st["resident"] <= 2 and st["spilled"] >= 2
    assert bank.spills >= 2
    assert sorted(p.name for p in tmp_path.glob("client-*.npz"))[0] == \
        "client-00000000.npz"
    # a spilled client reloads bit for bit (and becomes resident again)
    rows = bank.rows(0)
    assert bank.loads == 1
    expect = pad_rows(sch.engine.task, sch.engine.nmax, sch.clients[0])
    for name in expect:
        np.testing.assert_array_equal(rows[name], expect[name])
    bank.drop(1)
    assert 1 not in bank
    with pytest.raises(KeyError):
        bank.rows(1)


def test_bank_budget_requires_spill_dir():
    """A RAM budget with nowhere to evict to would have to drop data:
    refused at construction."""
    sch = make_scheduler(make_clients(2, seed=3), capacity=2)
    with pytest.raises(ValueError, match="spill_dir"):
        ClientBank(sch.engine.task, sch.engine.nmax, ram_budget_bytes=1)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_spill_files_cross_the_packages(tmp_path, writer):
    """A client spilled by one package's bank is read by the other's from
    the same client-<id>.npz (the file names and npz keys are one)."""
    import repro.fed as ref_fed
    from repro.fed.bank import ClientBank as RefBank
    ours = make_clients(3, seed=5)
    theirs = make_clients(3, seed=5, pkg=ref_fed)
    nmax = max(c.n for c in ours)
    banks = {"port": (ClientBank, port_task(), ours),
             "reference": (RefBank, ref_task(), theirs)}
    bank_cls, task, clients = banks[writer]
    row_nbytes = bank_cls(task, nmax).row_nbytes
    spiller = bank_cls(task, nmax, spill_dir=str(tmp_path),
                       ram_budget_bytes=row_nbytes)
    for i, c in enumerate(clients):
        spiller.put(i, c)
    assert spiller.stats()["spilled"] == 2
    reader_cls, reader_task, _ = banks["port" if writer == "reference"
                                       else "reference"]
    reader = reader_cls(reader_task, nmax)
    for i in range(2):
        path = tmp_path / f"client-{i:08d}.npz"
        assert path.exists()
        reader._spilled[i] = str(path)
        rows = reader.rows(i)
        want = pad_rows(port_task(), nmax, ours[i])
        assert rows.keys() == want.keys()
        for name in want:
            assert rows[name].tobytes() == want[name].tobytes()
    assert reader.loads == 2


# -- upcoming_arrivals ---------------------------------------------------------

def upcoming_queues(pkg=None):
    """A FedState of the port (or of ``pkg``, the reference's fed package)
    with 4 founding clients in 6 slots and every arrival kind queued: a
    fresh payload (twice, the same object), a rejoin by id of an unslotted
    client, an arrival of a slotted client with and without a departure in
    the window, an unknown id; and a label for each client object."""
    clients = make_clients(4, seed=6, trace_idx=0, pkg=pkg)
    fresh = make_clients(1, seed=7, trace_idx=0, pkg=pkg)[0]
    state_cls, arrival, departure = (
        (FedState, Arrival, Departure) if pkg is None
        else (pkg.FedState, pkg.Arrival, pkg.Departure))
    st = state_cls(clients=clients, capacity=6, seed=0)
    # client 3 departs (including) at 1 and is unslotted afterwards
    st.push(departure(1, client_id=3, policy="include"))
    st.apply(st.pop_event(), 1)
    st.push(arrival(2, client=fresh),
            arrival(3, client_id=3),                  # unslotted rejoin
            departure(4, client_id=1, policy="include"),
            arrival(4, client_id=1),                  # evict + rejoin
            arrival(5, client_id=0),                  # slotted: no stage
            arrival(6, client=fresh),                 # the same payload
            departure(7, client_id=2, policy="include"),
            arrival(8, client_id=2),                  # departs at 7
            arrival(9, client_id=99))                 # unknown id
    labels = {id(fresh): "fresh"}
    labels.update({id(c): f"client{i}" for i, c in enumerate(clients)})
    return st, labels


@pytest.mark.parametrize("until", list(range(0, 11)))
def test_upcoming_arrivals_equals_the_reference(until):
    import repro.fed as ref_fed
    ours, our_labels = upcoming_queues()
    theirs, their_labels = upcoming_queues(ref_fed)
    got = [(cid, our_labels[id(c)]) for cid, c in
           ours.upcoming_arrivals(until)]
    want = [(cid, their_labels[id(c)]) for cid, c in
            theirs.upcoming_arrivals(until)]
    assert got == want
    if until >= 4:      # client 1: slotted, departing in the window
        assert (1, "client1") in got
    assert all(cid != 0 for cid, _ in got)
    assert [label for _, label in got].count("fresh") == (until >= 2)


# -- bit-identity against the resident scheduler --------------------------------

@pytest.mark.parametrize("scenario", ["flash-crowd", "diurnal"])
@pytest.mark.parametrize("engine_mode",
                         ["client_parallel", "client_sequential"])
def test_bank_prefetch_bit_identical_to_resident(scenario, engine_mode):
    """Routing admits through the bank and the staging thread changes when
    bytes move, never which bytes: history and params bit-identical to the
    resident scheduler."""
    rounds = 14
    plain = build_scheduler(make_scenario(scenario, seed=0),
                            engine_mode=engine_mode, device="cpu")
    plain.run(rounds, eval_every=7)
    banked = build_scheduler(make_scenario(scenario, seed=0),
                             engine_mode=engine_mode, prefetch=True,
                             device="cpu")
    banked.run(rounds, eval_every=7)
    banked.close()
    assert_history_identical(plain.history, banked.history)
    assert_params_bitwise(plain.params, banked.params)
    ps = banked.prefetch_stats()
    assert ps["stager"]["stage_errors"] == 0
    if scenario == "flash-crowd":         # its arrivals all prefetch
        assert ps["hits"] > 0 and ps["misses"] == 0


FLEET, HOT, FLEET_ROUNDS = 16, 6, 24


@pytest.mark.parametrize("agg", ["flat", "auto"])
def test_fleet_beyond_capacity_against_all_resident(agg):
    """The rotation scenario cycles a fleet of 16 through 6 hot slots
    (evict to the bank, rejoin from it) against the same schedule on an
    engine that holds everyone (plan mode draws per occupied slot in slot
    order, so the trajectories compare across capacities; the big run's
    extra slots stay zero).  With ``agg="flat"`` (the card's default, its
    plain version here: one client after another) the params are
    bit-identical, as the reference asserts.  With the CPU's default
    (``"tree"``: ``(c * d).sum(0)`` per leaf) a sum over 6 rows and one
    over 16 (10 of them zero) round differently from round 0 on; over the
    24 rounds the distance peaks at 0.55 PARAM_TOLs (ROADMAP Limits), so
    the records are held equal, eval losses to LOSS_RTOL and the params to
    PARAM_TOL."""
    def scenario():
        return make_scenario("rotation", seed=0, fleet=FLEET, hot=HOT,
                             dwell=2, n_rounds=FLEET_ROUNDS)
    small = build_scheduler(scenario(), mode="plan", prefetch=True,
                            agg=agg, device="cpu")
    small.run(FLEET_ROUNDS, eval_every=8)
    small.close()
    big = build_scheduler(scenario(), mode="plan", capacity=FLEET, agg=agg,
                          device="cpu")
    big.run(FLEET_ROUNDS, eval_every=8)

    assert small.engine.capacity == HOT < big.engine.capacity
    assert len(small.clients) > HOT       # the fleet exceeded the slots
    ps = small.prefetch_stats()
    assert ps["bank"]["clients"] == len(small.clients)
    assert ps["misses"] == 0 and ps["stager"]["stage_errors"] == 0
    events = "".join(h.event for h in small.history)
    assert "departure-include:" in events and "rejoin:" in events
    bitwise = small.engine.agg == "flat"
    for r1, r2 in zip(small.history, big.history, strict=True):
        assert r1.tau == r2.tau and r1.event == r2.event
        assert r1.eta == r2.eta and r1.n_active == r2.n_active
        np.testing.assert_array_equal(np.asarray(r1.s),
                                      np.asarray(r2.s)[:HOT])
        assert not np.asarray(r2.s)[HOT:].any()
        assert np.isnan(r1.loss) == np.isnan(r2.loss)
        if bitwise:
            np.testing.assert_array_equal(r1.loss, r2.loss)
        elif not np.isnan(r2.loss):
            np.testing.assert_allclose(r1.loss, r2.loss, rtol=LOSS_RTOL)
    if bitwise:
        assert_params_bitwise(small.params, big.params)
    else:
        for k, v in big.params.items():
            torch.testing.assert_close(small.params[k], v, **PARAM_TOL)


# -- staged-cohort corners -------------------------------------------------------

def test_prefetch_churn_never_misses():
    """tests/test_bank.py's churn case (its compile count has no meaning
    for the port, which compiles nothing): over 12 rotation boundaries of
    evict and rejoin with prefetch on, every admit is a prefetch hit, on
    one engine."""
    sch = build_scheduler(
        make_scenario("rotation", seed=1, fleet=10, hot=4, dwell=2,
                      n_rounds=48), prefetch=True, device="cpu")
    sch.eval_fn = None
    sch.run(16, eval_every=NO_EVAL)
    engine = sch.engine
    hits = sch.prefetch_hits
    sch.run(24, eval_every=NO_EVAL)       # 12 more churn boundaries
    sch.close()
    assert sch.engine is engine
    ps = sch.prefetch_stats()
    assert ps["misses"] == 0 and ps["stager"]["stage_errors"] == 0
    assert sch.prefetch_hits >= hits + 12


def test_evicted_client_rejoins_within_staged_cohort():
    """A Departure and an Arrival of the same client coalesce at one
    boundary: upcoming_arrivals stages the still-slotted client, the
    boundary evicts then re-admits it from the staged cohort, and the run
    is the unprefetched one bit for bit."""
    def build(prefetch):
        return make_scheduler(
            make_clients(3, seed=8, trace_idx=0), capacity=3,
            max_samples=600, prefetch=prefetch,
            events=[Departure(4, client_id=0, policy="include"),
                    Arrival(4, client_id=0)])

    plain = build(False)
    plain.run(8, eval_every=8)
    sch = build(True)
    sch.run(8, eval_every=8)
    sch.close()
    assert sch.prefetch_stats()["hits"] == 1
    assert sch.prefetch_stats()["misses"] == 0
    assert 0 in sch.slot_of               # re-admitted at the boundary
    for h in sch.history:                 # cpu_0: s = E surely throughout
        assert h.s[sch.slot_of[0]] == 5.0
    assert_history_identical(plain.history, sch.history)
    assert_params_bitwise(plain.params, sch.params)


def test_trace_shift_after_staging_is_not_stale():
    """Staged cohorts carry data rows only; n and the s-law come from the
    live Client at commit, so a law changed between staging and the
    boundary wins."""
    sch = make_scheduler(make_clients(2, seed=9, trace_idx=4),
                         capacity=3, max_samples=600, prefetch=True)
    new_cl = make_clients(1, seed=10, trace_idx=4)[0]   # cpu_90
    sch.push(Arrival(4, client=new_cl))
    sch.run(2, eval_every=NO_EVAL)
    assert sch._stager.stats()["cohorts_staged"] == 0   # not collected
    new_cl.trace = TRACES[0]              # cpu_0: s = E surely
    sch.run(6, eval_every=NO_EVAL)
    sch.close()
    assert sch.prefetch_stats()["hits"] == 1
    slot = sch.slot_of[2]
    np.testing.assert_array_equal(sch.engine.s_cdf[slot].numpy(),
                                  trace_cdf_row(TRACES[0], sch.engine.E))
    post = [h.s[slot] for h in sch.history if h.tau >= 4]
    assert post and all(s == 5.0 for s in post)


def test_stager_failure_falls_back_to_sync_admit():
    """A staging failure degrades to the synchronous path, counted in
    stage_errors and as a miss, never corrupting state or hanging the
    boundary."""
    sch = make_scheduler(make_clients(2, seed=12, trace_idx=0),
                         capacity=3, max_samples=600, prefetch=True)
    new_cl = make_clients(1, seed=13, trace_idx=0)[0]
    stager = sch._stager

    def boom(items, box):
        box["err"] = RuntimeError("injected staging failure")
        box["done"].set()
    stager._stage = boom
    sch.push(Arrival(2, client=new_cl))
    sch.run(6, eval_every=NO_EVAL)
    sch.close()
    assert stager.stage_errors == 1
    assert sch.prefetch_stats()["misses"] == 1       # the sync fallback
    slot = sch.slot_of[2]
    assert all(h.s[slot] == 5.0 for h in sch.history if h.tau >= 2)
    np.testing.assert_array_equal(
        sch.engine.data["x"][slot, :new_cl.n].numpy(), new_cl.x)


def test_cohort_stager_supersede_and_close():
    sch = make_scheduler(make_clients(2, seed=14), capacity=4,
                         max_samples=600)
    stager = CohortStager(sch.engine)
    c = make_clients(1, seed=15)[0]
    go = threading.Event()
    orig = stager._stage

    def slow(items, box):
        go.wait(5.0)
        orig(items, box)
    stager._stage = slow
    stager.submit([(None, c)])
    stager.submit([(None, c)])            # supersedes the in-flight one
    go.set()
    cohort = stager.collect()
    assert cohort is not None and cohort.k == 1
    assert stager.superseded == 1
    assert stager.collect() is None       # consumed
    rows = pad_rows(sch.engine.task, sch.engine.nmax, c)
    for name, want in rows.items():
        np.testing.assert_array_equal(cohort.dev[name][0].numpy(), want)
    stager.close()
    stager.close()                        # idempotent
    assert stager._worker is None


def test_staged_cohorts_pad_to_a_power_of_two():
    sch = make_scheduler(make_clients(2, seed=16), capacity=8,
                         max_samples=600)
    stager = CohortStager(sch.engine)
    new = make_clients(3, seed=17)
    stager.submit([(None, c) for c in new])
    cohort = stager.collect()
    stager.close()
    assert cohort.k == 3 and cohort.dev["x"].shape[0] == 4
    assert torch.equal(cohort.dev["x"][3], cohort.dev["x"][2])
    assert cohort.index == {id(c): j for j, c in enumerate(new)}
    st = stager.stats()
    assert st["cohorts_staged"] == 1 and st["rows_staged"] == 3
    assert 0.0 <= st["overlap_fraction"] <= 1.0


# -- chunked (v2) checkpoints ---------------------------------------------------

def eval_fn(params, x, y):
    return P._paper_eval_fn()(params, x, y)


def test_chunked_checkpoint_resume_bit_exact(tmp_path):
    """A bank-backed scheduler saves one npz per client (v2) and a
    restored run, bank and stager rebuilt, continues bit for bit."""
    def build():
        return make_scheduler(
            make_clients(3, seed=20), capacity=4, max_samples=600,
            eval_fn=eval_fn, prefetch=True,
            events=[Arrival(3, client=make_clients(1, seed=21,
                                                   trace_idx=0)[0])])
    ref = build()
    ref.run(10, eval_every=5)
    ref.close()
    sch = build()
    sch.run(6, eval_every=5)
    ckpt = tmp_path / "ckpt"
    sch.save(str(ckpt))
    sch.close()
    assert len(sorted((ckpt / "clients").glob("client-*.npz"))) == 4
    res = StreamScheduler.restore(str(ckpt), loss_fn=make_loss_fn(CFG),
                                  eval_fn=eval_fn, device="cpu")
    assert res.bank is not None and res._stager is not None
    assert res.bank.stats()["clients"] == 4
    res.run(4, eval_every=5)
    res.close()
    assert_history_identical(ref.history, res.history)
    assert_params_bitwise(ref.params, res.params)


def test_chunked_checkpoint_rejects_corrupt_chunk(tmp_path):
    sch = make_scheduler(make_clients(3, seed=22), capacity=3,
                         max_samples=600, prefetch=True)
    sch.run(4, eval_every=4)
    ckpt = tmp_path / "ckpt"
    sch.save(str(ckpt))
    sch.close()
    chunk = sorted((ckpt / "clients").glob("client-*.npz"))[1]
    raw = bytearray(chunk.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    chunk.write_bytes(bytes(raw))
    with pytest.raises(CorruptCheckpointError):
        StreamScheduler.restore(str(ckpt), loss_fn=make_loss_fn(CFG),
                                device="cpu")


# -- a raising boundary ----------------------------------------------------------

def full_engine_run(pkg):
    """One founding client in 2 slots, two brand-new clients arriving at
    tau 1: the first takes the free slot, the second finds none and its
    Arrival raises.  Returns (scheduler, the first newcomer)."""
    if pkg is None:
        clients = make_clients(3, seed=30, trace_idx=2)
        sch = make_scheduler(clients[:1], capacity=2, max_samples=600,
                             mode="plan",
                             events=[Arrival(1, client=clients[1]),
                                     Arrival(1, client=clients[2])])
        return sch, clients[1]
    import jax
    from repro.configs.paper import SYNTHETIC_LR as RCFG
    from repro.models.small import init_small as rinit
    from repro.models.small import make_loss_fn as rloss
    clients = make_clients(3, seed=30, trace_idx=2, pkg=pkg)
    sch = pkg.StreamScheduler(
        clients=clients[:1], init_params=rinit(jax.random.PRNGKey(0), RCFG),
        loss_fn=rloss(RCFG), capacity=2, max_samples=600, local_epochs=5,
        batch_size=6, scheme="C", eta0=1.0, seed=0, mode="plan",
        chunk_size=4, events=[pkg.Arrival(1, client=clients[1]),
                              pkg.Arrival(1, client=clients[2])])
    return sch, clients[1]


def test_a_raising_boundary_still_writes_its_recorded_admits(monkeypatch):
    """The reference's _apply_events flushes the admits it recorded even
    when a later event raises ("capacity exhausted"): FedState gave the
    first newcomer slot 1, so the engine must hold its rows, n and s-law
    there, as the reference's does."""
    import repro.fed as ref_fed
    from repro.fed.engine import trace_cdf_row as ref_cdf_row
    monkeypatch.setattr(port_engine, "trace_cdf_row", ref_cdf_row)
    monkeypatch.setattr(port_stream, "trace_cdf_row", ref_cdf_row)
    runs = {}
    for name, pkg in (("port", None), ("reference", ref_fed)):
        sch, newcomer = full_engine_run(pkg)
        with pytest.raises(RuntimeError, match="capacity 2 exhausted"):
            sch.run(3, eval_every=NO_EVAL)
        assert sch.slot_of[1] == 1 and len(sch.history) == 1
        runs[name] = (sch, newcomer)
    port, newcomer = runs["port"]
    ref, _ = runs["reference"]
    eng, reng = port.engine, ref.engine
    assert int(eng.n[1]) == int(np.asarray(reng.n)[1]) == newcomer.n
    np.testing.assert_array_equal(eng.s_cdf[1].numpy(),
                                  np.asarray(reng.s_cdf)[1])
    np.testing.assert_array_equal(eng.s_cdf[1].numpy(),
                                  ref_cdf_row(newcomer.trace, eng.E))
    for name in ("x", "y"):
        np.testing.assert_array_equal(eng.data[name][1].numpy(),
                                      np.asarray(reng.data[name])[1])
    np.testing.assert_array_equal(eng.data["x"][1, :newcomer.n].numpy(),
                                  newcomer.x)


# -- across the packages: the banked schedulers, teacher-forced ---------------

BANK_CASES = [(name, mode) for name in ("rotation", "flash-crowd")
              for mode in ("device", "plan")]


@pytest.fixture(scope="module", params=BANK_CASES,
                ids=[f"{n}-{m}" for n, m in BANK_CASES])
def banked(request):
    """The reference's prefetching scheduler and the port's on one short
    scenario, one round at a time, the port starting each round from the
    reference's params: both schedulers and each round's params after
    it."""
    from repro.fed import scenarios as R
    from repro.fed.engine import trace_cdf_row as ref_cdf_row
    name, mode = request.param
    seed, knobs = SHORT[name]
    rsc = R.make_scenario(name, seed=seed, **knobs)
    psc = P.make_scenario(name, seed=seed, **knobs)
    rsc.eta0 = psc.eta0 = SHORT_ETA0.get(name, psc.eta0)
    with pytest.MonkeyPatch.context() as mp:
        # the port draws from the reference's s-law table, on both of its
        # paths to a slot's law (admit_many and a prefetch hit)
        mp.setattr(port_engine, "trace_cdf_row", ref_cdf_row)
        mp.setattr(port_stream, "trace_cdf_row", ref_cdf_row)
        ref = R.build_scheduler(rsc, mode=mode, prefetch=True)
        port = P.build_scheduler(psc, mode=mode, prefetch=True,
                                 device="cpu")
        ref_after, port_after = [], []
        for _ in range(knobs["n_rounds"]):
            port.params = from_jax({k: np.asarray(v)
                                    for k, v in ref.params.items()},
                                   CFG, "cpu")
            ref.run(1, eval_every=EVAL_EVERY)
            port.run(1, eval_every=EVAL_EVERY)
            ref_after.append({k: np.asarray(v)
                              for k, v in ref.params.items()})
            port_after.append(to_numpy(port.params, CFG))
        ref.close()
        port.close()
    return dict(ref=ref, port=port, ref_after=ref_after,
                port_after=port_after)


def test_banked_scheduler_records_equal_the_reference(banked):
    port, ref = banked["port"], banked["ref"]
    assert_records_equal(port.history, ref.history)
    assert "arrival:" in "".join(h.event for h in ref.history)
    assert port.slot_of == ref.slot_of
    got, want = port.prefetch_stats(), ref.prefetch_stats()
    assert (got["hits"], got["misses"]) == (want["hits"], want["misses"])
    assert got["hits"] > 0 and got["stager"]["stage_errors"] == 0
    assert got["bank"]["clients"] == want["bank"]["clients"]
    assert got["bank"]["row_nbytes"] == want["bank"]["row_nbytes"]


def test_banked_scheduler_teacher_forced_params(banked):
    for tau, (got, want) in enumerate(zip(banked["port_after"],
                                          banked["ref_after"], strict=True)):
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, err_msg=f"{k} tau={tau}",
                                       **PARAM_TOL)
