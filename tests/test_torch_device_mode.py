"""The port's device-mode sampling against the reference's, bit for bit.

- ``repro_torch.core.prng`` against ``jax.random``: keys, ``fold_in``,
  ``split``, ``bits`` and ``uniform`` equal word for word (jax's default
  threefry2x32 with ``jax_threefry_partitionable``, in 32-bit mode).
- ``device_sample_round`` and ``device_sample_span``: the port's alpha and
  batch indices equal the reference's exactly, given the same s-law table,
  with inactive and empty slots.
- The s-law table: the port evaluates the incomplete beta in float64
  (scipy), the reference in f32 (jax runs with x64 off), so the two tables
  differ by at most 2e-6; the port's table has the reference's properties
  and its draws follow ``Trace.sample_s``'s law.
- Slot writes (admit, admit_many, commit_burst with reordered rows, evict,
  set_trace) leave the port's n, s-law and data rows equal to the
  reference's.
- ``FederatedTrainer(engine="device")`` round for round against the
  reference's, through an arrival, an excluding departure, a TraceShift
  and an InactivityBurst, in both round modes and on the f32 and int8
  wires; its draws do not depend on how the rounds are cut into run()
  calls; ``delta_norm`` against the reference's ``with_metrics`` round.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fed as ref_fed
import repro.fed.engine as ref_engine
import repro_torch.fed as port_fed
import repro_torch.fed.engine as port_engine
from repro.configs.paper import SYNTHETIC_LR
from repro.core.participation import TRACES
from repro.data import synthetic_federation as ref_synthetic_federation
from repro.models.small import init_small, make_loss_fn
from repro_torch.configs import paper as port_configs
from repro_torch.core import prng
from repro_torch.core.participation import TRACES as PORT_TRACES
from repro_torch.data import synthetic_federation
from repro_torch.models import small as port_small
from repro_torch.params import from_jax, to_numpy
from test_torch_quant import _port_flat, _step_bound
from test_torch_trainer import PARAM_TOL, port_eval, ref_eval


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside the other test workers, a pool of
    threads per process oversubscribes the cores, and its idle threads
    spin, slowing every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PCFG = port_configs.PAPER_CONFIGS[SYNTHETIC_LR.name]
SEEDS = (0, 1, 12345, 2 ** 31 - 1)
TAUS = (0, 1, 7, 999, 2 ** 31 + 3)
SHAPES = ((20,), (7,), (62, 5, 20))
# jax's f32 betainc against scipy's f64 (cast to f32): at most 1.9e-6
TABLE_ATOL = 2e-6


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


# -- core.prng against jax.random ---------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_prng_equals_jax_random_bit_for_bit(seed):
    # the draws below rest on jax's partitionable threefry (jax >= 0.5's
    # default), which the reference's device mode runs under
    assert jax.config.jax_threefry_partitionable is True
    jk, pk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(pk.numpy(), _words(jk))
    for tau in TAUS:
        np.testing.assert_array_equal(prng.fold_in(pk, tau).numpy(),
                                      _words(jax.random.fold_in(jk, tau)))
    for num in (2, 5):
        np.testing.assert_array_equal(prng.split(pk, num).numpy(),
                                      _words(jax.random.split(jk, num)))
    for shape in SHAPES:
        want = np.asarray(jax.random.uniform(jk, shape))
        got = prng.uniform(pk, shape).numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        np.testing.assert_array_equal(prng.random_bits(pk, shape).numpy(),
                                      _words(jax.random.bits(jk, shape)))


def test_prng_batches_keys_as_vmap_does():
    jk, pk = jax.random.PRNGKey(3), prng.prng_key(3)
    taus = np.arange(5, 12)
    jkeys = jax.vmap(lambda t: jax.random.fold_in(jk, t))(jnp.asarray(taus))
    pkeys = prng.fold_in(pk, torch.from_numpy(taus))
    np.testing.assert_array_equal(pkeys.numpy(), _words(jkeys))
    want = jax.vmap(lambda k: jax.random.uniform(k, (4, 3)))(jkeys)
    np.testing.assert_array_equal(prng.uniform(pkeys, (4, 3)).numpy(),
                                  np.asarray(want))
    np.testing.assert_array_equal(
        prng.split(pkeys).numpy(),
        _words(jax.vmap(jax.random.split)(jkeys)))
    with pytest.raises(ValueError, match=r"\(\.\.\., 2\)"):
        prng.uniform(torch.zeros(3, dtype=torch.int64), (2,))


# -- the device draw ----------------------------------------------------------

def _slots(E=5):
    """A capacity of 8: 6 clients (their table is the reference's), 2
    empty slots (n 1, all mass at s = 0); slots 2 and 6 inactive."""
    rng = np.random.default_rng(4)
    traces = [TRACES[i] for i in rng.integers(0, 8, size=6)]
    cdf = np.concatenate([np.stack([ref_engine.trace_cdf_row(t, E)
                                    for t in traces]),
                          np.tile(ref_engine.empty_slot_cdf(E), (2, 1))])
    n = np.array([37, 12, 60, 1, 45, 8, 1, 1], np.int32)
    active = np.array([1, 1, 0, 1, 1, 1, 0, 0], np.float32)
    return active, n, cdf


@pytest.mark.parametrize("seed", (0, 12345))
def test_device_sample_round_equals_the_reference(seed):
    E, B = 5, 20
    active, n, cdf = _slots(E)
    for tau in (0, 1, 7, 999):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), tau)
        ra, ri = ref_engine.device_sample_round(
            key, jnp.asarray(active), jnp.asarray(n), jnp.asarray(cdf), E, B)
        pa, pi = port_engine.device_sample_round(
            prng.fold_in(prng.prng_key(seed), tau), torch.from_numpy(active),
            torch.from_numpy(n), torch.from_numpy(cdf), E, B)
        assert pa.dtype == torch.float32 and pi.dtype == torch.int32
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        # inactive and empty slots never train; indices stay in range
        assert not pa.numpy()[active == 0].any()
        assert (pi.numpy() < n[:, None, None]).all()


def test_device_sample_span_equals_the_reference():
    E, B, R = 3, 4, 6
    active, n, cdf = _slots(E)
    ra, ri = ref_engine.device_sample_span(
        jax.random.PRNGKey(2), R, jnp.asarray(active), jnp.asarray(n),
        jnp.asarray(cdf), E, B)
    pa, pi = port_engine.device_sample_span(
        prng.prng_key(2), R, torch.from_numpy(active), torch.from_numpy(n),
        torch.from_numpy(cdf), E, B)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    # a span starting later draws the same rounds: fold_in(key, tau)
    la, li = port_engine.device_sample_span(
        prng.prng_key(2), R - 2, torch.from_numpy(active),
        torch.from_numpy(n), torch.from_numpy(cdf), E, B, tau0=2)
    assert torch.equal(la, pa[2:]) and torch.equal(li, pi[2:])


# -- the s-law table ----------------------------------------------------------

@pytest.mark.parametrize("E", (1, 2, 3, 5, 10, 20))
def test_trace_s_cdf_within_the_f32_betainc_of_the_reference(E):
    got = port_engine.trace_s_cdf(
        [port_fed.Client(x=np.zeros((1, 1)), trace=t) for t in PORT_TRACES],
        E)
    want = ref_engine.trace_s_cdf(
        [ref_fed.Client(x=np.zeros((1, 1)), trace=t) for t in TRACES], E)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TABLE_ATOL)


def _port_clients(n, seed):
    train, test = synthetic_federation(0.5, 0.5, n, seed=seed)
    rng = np.random.default_rng(seed)
    return [port_fed.Client(x=tr[0], y=tr[1],
                            trace=PORT_TRACES[rng.integers(0, 8)],
                            x_test=te[0], y_test=te[1])
            for tr, te in zip(train, test)]


def test_trace_s_cdf_properties():
    """tests/test_engine.py::test_trace_s_cdf_properties on the port."""
    clients = _port_clients(8, seed=3)
    cdf = port_engine.trace_s_cdf(clients, 5)
    assert cdf.shape == (8, 6)
    assert np.all(np.diff(cdf, axis=1) >= -1e-6)      # monotone
    np.testing.assert_allclose(cdf[:, -1], 1.0)
    for i, c in enumerate(clients):
        if c.trace.p_inactive == 0:
            assert cdf[i, 0] == 0.0                   # s >= 1 clamp
        else:
            assert cdf[i, 0] >= c.trace.p_inactive - 1e-6


def test_device_sampling_distribution():
    """tests/test_engine.py::test_engine_device_sampling_distribution on the
    port's own draws: per-client mean of s within a few stderr of the host
    sampler's; batch indices in range."""
    clients = _port_clients(6, seed=1)
    eng = port_fed.RoundEngine(loss_fn=port_small.make_loss_fn(PCFG),
                               clients=clients, local_epochs=5, batch_size=4,
                               device="cpu")
    alphas, idxs = port_engine.device_sample_span(
        prng.prng_key(0), 600, torch.ones(len(clients)), eng.n, eng.s_cdf,
        5, 4)
    s_dev = alphas.sum(-1).numpy()                    # (600, C)
    rng = np.random.default_rng(0)
    s_host = np.stack([[c.trace.sample_s(rng, 5) for c in clients]
                       for _ in range(600)])
    np.testing.assert_allclose(s_dev.mean(0), s_host.mean(0), atol=0.35)
    n = eng.n.numpy()
    assert (idxs.numpy() < n[None, :, None, None]).all()
    assert (idxs.numpy() >= 0).all()


# -- slot writes --------------------------------------------------------------

def _ref_clients(n, seed):
    train, test = ref_synthetic_federation(0.5, 0.5, n, seed=seed)
    rng = np.random.default_rng(seed)
    return [ref_fed.Client(x=tr[0], y=tr[1], trace=TRACES[rng.integers(0, 8)],
                           x_test=te[0], y_test=te[1])
            for tr, te in zip(train, test)]


def _stack(clients, nmax):
    out = {}
    for name, dtype in (("x", np.float32), ("y", np.int32)):
        rows = np.zeros((len(clients), nmax) + getattr(
            clients[0], name).shape[1:], dtype)
        for j, c in enumerate(clients):
            rows[j, :c.n] = getattr(c, name)
        out[name] = rows
    return out


def test_slot_writes_match_the_reference(monkeypatch):
    """tests/test_engine.py::test_admit_many_matches_single_admits across
    the two packages: the same sequence of admit, admit_many, commit_burst
    (a staged stack committed reordered and in part), evict and set_trace
    leaves equal n, s-law and data rows.  The port is handed the
    reference's table, so the s-law rows compare exactly."""
    monkeypatch.setattr(port_engine, "trace_cdf_row",
                        ref_engine.trace_cdf_row)
    fresh = {"ref": _ref_clients(4, seed=77), "port": _port_clients(4, 77)}
    nmax = max(c.n for c in fresh["port"]) + 3
    engs = {
        "ref": ref_fed.RoundEngine(
            loss_fn=make_loss_fn(SYNTHETIC_LR), clients=_ref_clients(4, 0),
            local_epochs=5, batch_size=10, capacity=8, max_samples=nmax),
        "port": port_fed.RoundEngine(
            loss_fn=port_small.make_loss_fn(PCFG),
            clients=_port_clients(4, 0), local_epochs=5, batch_size=10,
            capacity=8, max_samples=nmax, device="cpu")}
    shift = {"ref": TRACES[5], "port": PORT_TRACES[5]}
    for side, eng in engs.items():
        f = fresh[side]
        eng.admit(4, f[0])
        eng.admit_many([(5, f[1]), (6, f[2])])
        staged = eng.put_burst(_stack([f[3], f[0]], eng.nmax))
        eng.commit_burst(staged, slots=[7, 3], ns=[f[0].n, f[3].n],
                         cdfs=[ref_engine.trace_cdf_row(c.trace, 5)
                               for c in (f[0], f[3])], idx=[1, 0])
        eng.evict(2)
        eng.set_trace(1, shift[side])
    ref, port = engs["ref"], engs["port"]
    np.testing.assert_array_equal(port.n.numpy(), np.asarray(ref.n))
    np.testing.assert_array_equal(port.s_cdf.numpy(), np.asarray(ref.s_cdf))
    for name in ref.data:
        np.testing.assert_array_equal(port.data[name].numpy(),
                                      np.asarray(ref.data[name]))
    assert port.n[2] == 1 and (port.s_cdf[2] == 1).all()
    with pytest.raises(ValueError, match="duplicate slots"):
        port.admit_many([(5, fresh["port"][0]), (5, fresh["port"][1])])
    with pytest.raises(IndexError, match="out of range"):
        port.set_trace(8, shift["port"])


# -- the device-mode trainer --------------------------------------------------

N_CLIENTS = 10
ROUNDS = 14


def _trainer_clients(client_cls, traces, port: bool):
    train, test = (synthetic_federation if port else
                   ref_synthetic_federation)(0.5, 0.5, N_CLIENTS, seed=0)
    rng = np.random.default_rng(0)
    clients = [client_cls(x=tr[0], y=tr[1], trace=traces[rng.integers(0, 8)],
                          x_test=te[0], y_test=te[1])
               for tr, te in zip(train, test)]
    clients[-1].active_from = 3
    clients[2].departs_at = 6
    clients[2].departure_policy = "exclude"
    return clients


def _events(pkg, traces):
    return [pkg.TraceShift(5, client_id=1, trace=traces[5]),
            pkg.InactivityBurst(8, duration=3, client_ids=(0, 4))]


def _init():
    return {k: np.asarray(v) for k, v in
            init_small(jax.random.PRNGKey(0), SYNTHETIC_LR).items()}


def _port_trainer(**kw):
    tr = port_fed.FederatedTrainer(
        loss_fn=port_small.make_loss_fn(PCFG), eval_fn=port_eval(PCFG),
        init_params=from_jax(_init(), PCFG, "cpu"),
        clients=_trainer_clients(port_fed.Client, PORT_TRACES, True),
        local_epochs=5, batch_size=10, scheme="C", eta0=0.5, seed=0,
        device="cpu", model_kind=PCFG.kind, **kw)
    tr._stream_scheduler().push(*_events(port_fed, PORT_TRACES))
    return tr


@pytest.mark.parametrize("wire", (None, "int8"))
@pytest.mark.parametrize("mode", ("client_parallel", "client_sequential"))
def test_device_mode_trainer_matches_the_reference(mode, wire, monkeypatch):
    """Every record equal to the reference's ``engine="device"`` run and
    the params within PARAM_TOL after every span (each round started from
    the reference's params; on int8 plus one code step per client, as in
    tests/test_torch_quant.py).  The port is handed the reference's s-law
    table (``trace_cdf_row`` patched): the two tables differ by up to
    2e-6, which could flip a draw that lands between them; given one
    table, the draws are the same bit for bit."""
    monkeypatch.setattr(port_engine, "trace_cdf_row",
                        ref_engine.trace_cdf_row)
    common = dict(engine="device", compression=wire, mode=mode)
    ref = ref_fed.FederatedTrainer(
        loss_fn=make_loss_fn(SYNTHETIC_LR), eval_fn=ref_eval(SYNTHETIC_LR),
        init_params={k: jnp.asarray(v) for k, v in _init().items()},
        clients=_trainer_clients(ref_fed.Client, TRACES, False),
        local_epochs=5, batch_size=10, scheme="C", eta0=0.5, seed=0,
        interpret=True, **common)
    ref._stream_scheduler().push(*_events(ref_fed, TRACES))
    port = _port_trainer(**common)
    calls = []
    name = "fed_round_" + mode.split("_")[1]
    real = getattr(port_engine, name)

    def spy(loss_fn, params, batches, alpha, coeffs, eta, **kw):
        calls.append(({k: v.clone() for k, v in params.items()}, batches,
                      alpha, coeffs, eta))
        return real(loss_fn, params, batches, alpha, coeffs, eta, **kw)
    monkeypatch.setattr(port_engine, name, spy)

    for _ in range(ROUNDS):
        port.params = from_jax({k: np.asarray(v)
                                for k, v in ref.params.items()}, PCFG, "cpu")
        w = ref.run(1, eval_every=4)[-1]
        g = port.run(1, eval_every=4)[-1]
        assert (g.tau, g.eta, g.n_active, g.event) == \
            (w.tau, w.eta, w.n_active, w.event)
        np.testing.assert_array_equal(g.s, w.s)
        assert np.isnan(g.loss) == np.isnan(w.loss)
        got = _port_flat(port.params)
        want = _port_flat(from_jax({k: np.asarray(v)
                                    for k, v in ref.params.items()},
                                   PCFG, "cpu"))
        tol = PARAM_TOL["atol"] + PARAM_TOL["rtol"] * want.abs()
        if wire is not None:
            tol = tol + _step_bound(wire, PCFG, calls[-1])
        assert bool(((got - want).abs() <= tol).all()), \
            float(((got - want).abs() - tol).max())
    events = "".join(h.event for h in port.history)
    assert events == ("arrival:9;trace-shift:1;departure-exclude:2;"
                      "burst:0,4@3;")
    # the burst masks clients 0 and 4 for taus 8-10, then they resume
    s = np.stack([h.s for h in port.history])
    assert not s[8:11, [0, 4]].any() and s[11:, [0, 4]].any()
    assert port._scheduler.mode == "device"


def test_device_mode_is_invariant_to_how_rounds_are_cut():
    """run(20) against run(7) then run(13): params and records bit for
    bit (round tau draws from fold_in(key, tau) whatever the spans)."""
    one, two = _port_trainer(engine="device"), _port_trainer(engine="device")
    one.run(20, eval_every=5)
    two.run(7, eval_every=5)
    two.run(13, eval_every=5)
    for a, b in zip(one.history, two.history, strict=True):
        assert (a.tau, a.eta, a.n_active, a.event) == \
            (b.tau, b.eta, b.n_active, b.event)
        np.testing.assert_array_equal(a.s, b.s)
        np.testing.assert_array_equal(a.loss, b.loss)
    for k, v in one.params.items():
        assert torch.equal(v, two.params[k]), k
    # and the draws are not plan mode's
    plan = _port_trainer(engine="plan")
    plan.run(20, eval_every=5)
    assert any(not np.array_equal(a.s, b.s)
               for a, b in zip(one.history, plan.history))


@pytest.mark.parametrize("mode", ("client_parallel", "client_sequential"))
def test_delta_norm_matches_the_reference(mode):
    """``with_metrics``: each round's delta norm within rtol 1e-5 of the
    reference's, over a 3-round span from one plan, f32 and int8.  As in
    the reference, the parallel round takes the norm of the raw deltas
    (int8 reads as f32) and the sequential one after the wire's round
    trip (int8 reads otherwise)."""
    E, B, R = 5, 10, 3
    ref_clients = _ref_clients(6, seed=0)
    port_clients = _port_clients(6, seed=0)
    rng = np.random.default_rng(5)
    alphas = (rng.random((R, 6, E)) < 0.8).astype(np.float32)
    idxs = np.stack([rng.integers(0, c.n, size=(R, E, B))
                     for c in port_clients], axis=1)
    p = np.full(6, 1 / 6, np.float32)
    span = dict(p=p, lr_shift_tau=0, reboot_tau0=np.zeros(6, np.int32),
                reboot_boost=np.ones(6, np.float32))
    norms = {}
    for wire in (None, "int8"):
        ref = ref_fed.RoundEngine(
            loss_fn=make_loss_fn(SYNTHETIC_LR), clients=ref_clients,
            local_epochs=E, batch_size=B, eta0=0.5, with_metrics=True,
            compression=wire, mode=mode, interpret=True)
        _, want = ref.run_span(
            {k: jnp.asarray(v) for k, v in _init().items()}, 0, R,
            plan=(alphas, idxs), active=np.ones(6, np.float32), **span)
        port = port_fed.RoundEngine(
            loss_fn=port_small.make_loss_fn(PCFG), clients=port_clients,
            local_epochs=E, batch_size=B, eta0=0.5, with_metrics=True,
            compression=wire, mode=mode, model_kind=PCFG.kind, device="cpu")
        _, got = port.run_span(from_jax(_init(), PCFG, "cpu"), 0, R,
                               plan=(alphas, idxs), **span)
        np.testing.assert_allclose(got["delta_norm"].numpy(),
                                   np.asarray(want["delta_norm"]), rtol=1e-5)
        norms[wire] = got["delta_norm"]
    # the first round starts from the same params on both wires
    same = bool(norms[None][0] == norms["int8"][0])
    assert same == (mode == "client_parallel")
    off = port_fed.RoundEngine(
        loss_fn=port_small.make_loss_fn(PCFG), clients=port_clients,
        local_epochs=E, batch_size=B, device="cpu")
    _, m = off.run_span(from_jax(_init(), PCFG, "cpu"), 0, 2,
                        plan=(alphas[:2], idxs[:2]), **span)
    assert torch.equal(m["delta_norm"], torch.zeros(2))


def test_trainer_lists_delta_norms_with_metrics():
    tr = _port_trainer(engine="device", with_metrics=True)
    tr.run(4, eval_every=2)
    assert len(tr.delta_norms) == 4
    assert all(np.isfinite(x) and x > 0 for x in tr.delta_norms)
    with pytest.raises(ValueError, match="plan|device|host"):
        _port_trainer(engine="scan")


def test_run_span_takes_exactly_one_of_plan_or_key():
    eng = port_fed.RoundEngine(loss_fn=port_small.make_loss_fn(PCFG),
                               clients=_port_clients(3, 0), local_epochs=2,
                               batch_size=2, device="cpu")
    span = dict(p=np.full(3, 1 / 3, np.float32), lr_shift_tau=0,
                reboot_tau0=np.zeros(3, np.int32),
                reboot_boost=np.ones(3, np.float32))
    params = port_small.init_small(PCFG, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        eng.run_span(params, 0, 1, **span)
    with pytest.raises(ValueError, match="active="):
        eng.run_span(params, 0, 1, key=prng.prng_key(0), **span)
    _, m = eng.run_span(params, 0, 2, key=prng.prng_key(0),
                        active=np.ones(3, np.float32), **span)
    assert m["s"].shape == (2, 3) and m["eta"].shape == (2,)
    # the engine's draw is the reference's with the same table
    want = ref_engine.device_sample_span(
        jax.random.PRNGKey(0), 2, jnp.ones(3), jnp.asarray(eng.n.numpy()),
        jnp.asarray(eng.s_cdf.numpy()), 2, 2)[0]
    np.testing.assert_array_equal(m["s"].numpy(), np.asarray(want.sum(-1)))
    assert all(np.isfinite(v).all() for v in to_numpy(params, PCFG).values())


def test_quickstart_draws_the_reference_rounds_with_its_own_table():
    """examples/quickstart.py (SYNTHETIC(1, 1), 20 clients, logreg, scheme
    C, E 5, B 20, eta0 1.0, 50 rounds, eval every 5) on both packages from
    the same initial params, the port with its own float64 s-law table:
    every round record equal (no draw lands between the two tables here)
    and the final accuracy within one of the 400 held-out samples."""
    from repro_torch.benchmarks.reference import reference_init

    def trainer(pkg, client_cls, traces, federation, **kw):
        train, test = federation(1.0, 1.0, 20, seed=0)
        rng = np.random.default_rng(0)
        clients = [client_cls(x=tr[0], y=tr[1],
                              trace=traces[rng.integers(0, 8)],
                              x_test=te[0], y_test=te[1])
                   for tr, te in zip(train, test)]
        return pkg.FederatedTrainer(
            clients=clients, local_epochs=5, batch_size=20, scheme="C",
            eta0=1.0, seed=0, engine="device", **kw)

    ref = trainer(ref_fed, ref_fed.Client, TRACES, ref_synthetic_federation,
                  loss_fn=make_loss_fn(SYNTHETIC_LR),
                  eval_fn=ref_eval(SYNTHETIC_LR),
                  init_params=init_small(jax.random.PRNGKey(0), SYNTHETIC_LR),
                  chunk_size=16)
    port = trainer(port_fed, port_fed.Client, PORT_TRACES,
                   synthetic_federation,
                   loss_fn=port_small.make_loss_fn(PCFG),
                   eval_fn=port_eval(PCFG),
                   init_params=reference_init(PCFG, "cpu"), device="cpu")
    want, got = ref.run(50, eval_every=5), port.run(50, eval_every=5)
    for g, w in zip(got, want, strict=True):
        assert (g.tau, g.eta, g.n_active, g.event) == \
            (w.tau, w.eta, w.n_active, w.event)
        np.testing.assert_array_equal(g.s, w.s)
    assert abs(port.evaluate()[1] - ref.evaluate()[1]) <= 1 / 400
