"""The port's paper-table functions against the reference's.

- ``reference_init.npz`` is the reference's ``init_small(PRNGKey(0), cfg)``
  bit for bit, and two of ``reference_rows.json``'s rows are recomputed
  from the unmodified ``benchmarks/`` (Table 5 at (1.0, 1.0), tau0 10, and
  ``bound_check.run()``), so the committed files cannot go stale unseen;
  the tables' federations hash to the committed fingerprints;
- the trainers of one row of each table (``table3_trainer``,
  ``table4_trainer``, ``table5_trainer``), teacher-forced against the
  trainers the reference's table functions build: before every round the
  reference's params are copied into the port; the round records must be
  equal, the eval losses within rtol 1e-5, the accuracies equal and the
  params within PARAM_TOL after every round;
- Table 3 on SYNTHETIC, Table 4 and Table 5 free-running on the CPU at the
  reference's defaults: the rules of ``repro_torch.benchmarks.reference``
  hold with no failure, and every accuracy, difference, epoch and crossing
  equals the reference's;
- the rules themselves, on rows made to break each one.
"""
import math

import jax
import numpy as np
import pytest
import torch

import repro.fed as ref_fed
from benchmarks import bound_check as ref_bound_check
from benchmarks import paper_tables as ref_tables
from repro.configs.paper import MNIST_MLP, SYNTHETIC_LR
from repro.models.small import init_small, make_loss_fn
from repro_torch.benchmarks import paper_tables as port_tables
from repro_torch.benchmarks import reference as R
from repro_torch.configs import paper as port_configs
from repro_torch.params import from_jax, to_numpy

from test_torch_quant import _port_flat
from test_torch_trainer import PARAM_TOL


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside the other test workers, a pool of
    threads per process oversubscribes the cores, and its idle threads
    spin, slowing every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROWS = R.reference_rows()["rows"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: a table's port side is thousands of small ops,
    which a thread pool only slows, and beside other test workers the pool
    oversubscribes the cores (Table 3 on SYNTHETIC took 733 s instead of
    7 s in a six-worker run at the default thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cfg", [SYNTHETIC_LR, MNIST_MLP],
                         ids=lambda c: c.name)
def test_reference_init_is_init_small(cfg):
    want = {k: np.asarray(v)
            for k, v in init_small(jax.random.PRNGKey(0), cfg).items()}
    pcfg = port_configs.PAPER_CONFIGS[cfg.name]
    got = to_numpy(R.reference_init(pcfg, "cpu"), pcfg)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_committed_rows_are_recomputed_from_the_reference():
    assert ref_tables.table5_departure_crossing(
        taus=(10,), abs_=((1.0, 1.0),)) == [tuple(r) for r in ROWS["table5"]
                                             if r[:3] == [1.0, 1.0, 10]]
    assert [list(r) for r in ref_bound_check.run()] == ROWS["bound_check"]
    assert R.reference_rows()["command"].endswith(
        "tools/paper_reference.py")


def test_the_tables_data_hash_to_the_committed_fingerprints():
    assert R.data_fingerprints() == R.reference_rows()["data"]


# -- one row of each table, teacher-forced ------------------------------------

def _ref_trainer(table, args):
    """The trainer the reference's table function builds for that row
    (benchmarks/paper_tables.py)."""
    def trainer(cfg, clients, **kw):
        return ref_fed.FederatedTrainer(
            loss_fn=make_loss_fn(cfg), eval_fn=ref_tables._eval_fn(cfg),
            init_params=init_small(jax.random.PRNGKey(0), cfg),
            clients=clients, local_epochs=5, seed=0, **kw)
    if table == "table3":
        dataset, noniid, n_traces, scheme = args
        if dataset == "synthetic":
            ab = (1.0, 1.0) if noniid else (0.0, 0.0)
            clients = ref_tables._clients_synthetic(24, *ab, n_traces)
            cfg, eta0 = SYNTHETIC_LR, 1.0
        else:
            clients = ref_tables._clients_images(24, n_traces, noniid)
            cfg, eta0 = MNIST_MLP, 0.05
        return cfg, trainer(cfg, clients, batch_size=cfg.batch_size,
                            scheme=scheme, eta0=eta0)
    if table == "table4":
        tau0, fast = args
        clients = ref_tables._clients_synthetic(9, 1.0, 1.0, 5, seed=4)
        extra = ref_tables._clients_synthetic(1, 1.0, 1.0, 5, seed=99)[0]
        extra.active_from = tau0
        clients.append(extra)
        return SYNTHETIC_LR, trainer(SYNTHETIC_LR, clients, batch_size=20,
                                     scheme="C", eta0=1.0, fast_reboot=fast)
    a, b, tau0, policy = args
    clients = ref_tables._clients_synthetic(10, a, b, 5, seed=7)
    clients[0].departs_at = tau0
    clients[0].departure_policy = policy
    return SYNTHETIC_LR, trainer(SYNTHETIC_LR, clients, batch_size=20,
                                 scheme="C", eta0=1.0)


# (table, trainer arguments, rounds, eval_every): the rows chip_smoke.py
# teacher-forces on the card (Table 3's at fewer rounds), Table 3 on images
# and the arrival and departure at tau0 3.  Not Table 3's iid rows: their
# first round's five local steps at eta0 1.0 from small params amplify
# f32 noise to 1e-3 of the update (6.7e-6 at iid |T| 4, scheme A), beyond
# PARAM_TOL, though the rows' samples are the reference's (PERF.md §6)
TEACHER_FORCED = {
    "table3-synthetic-niid-8-C": ("table3", ("synthetic", True, 8, "C"), 6,
                                  5),
    "table3-synthetic-niid-8-A": ("table3", ("synthetic", True, 8, "A"), 6,
                                  5),
    "table3-synthetic-niid-8-B": ("table3", ("synthetic", True, 8, "B"), 6,
                                  5),
    "table3-images-niid-4-B": ("table3", ("images", True, 4, "B"), 2, 5),
    "table4-fast": ("table4", (3, True), 6, 1),
    "table4-vanilla": ("table4", (3, False), 6, 1),
    "table5-include": ("table5", (1.0, 1.0, 3, "include"), 6, 1),
    "table5-exclude": ("table5", (1.0, 1.0, 3, "exclude"), 6, 1),
}


@pytest.mark.parametrize("case", sorted(TEACHER_FORCED))
def test_table_row_matches_reference_round_for_round(case):
    table, args, rounds, every = TEACHER_FORCED[case]
    cfg, ref = _ref_trainer(table, args)
    pcfg = port_configs.PAPER_CONFIGS[cfg.name]
    make = {"table3": port_tables.table3_trainer,
            "table4": port_tables.table4_trainer,
            "table5": port_tables.table5_trainer}[table]
    port = make(*args, device="cpu")
    events = ""
    for tau in range(rounds):
        port.params = from_jax({k: np.asarray(v)
                                for k, v in ref.params.items()}, pcfg, "cpu")
        w = ref.run(1, eval_every=every)[-1]
        g = port.run(1, eval_every=every)[-1]
        assert (g.tau, g.eta, g.n_active, g.event) == \
            (w.tau, w.eta, w.n_active, w.event)
        np.testing.assert_array_equal(g.s, w.s)
        assert math.isnan(g.loss) == math.isnan(w.loss)
        if not math.isnan(w.loss):
            np.testing.assert_allclose(g.loss, w.loss, rtol=1e-5)
            assert g.acc == w.acc
        got = _port_flat(port.params)
        want = _port_flat(from_jax({k: np.asarray(v) for k, v in
                                    ref.params.items()}, pcfg, "cpu"))
        np.testing.assert_allclose(got.numpy(), want.numpy(), **PARAM_TOL,
                                   err_msg=f"tau={tau}")
        events += g.event
    if table != "table3":
        assert events, "the row's arrival or departure never happened"


# -- free-running on the CPU at the reference's defaults ----------------------

def _same_rows(rows, want):
    for g, w in zip(rows, want, strict=True):
        assert list(g) == list(w), (g, w)


@pytest.mark.parametrize("table", ["table3_synthetic", "table4", "table5"])
def test_port_table_reproduces_the_reference_rows(table):
    run, compare = {
        "table3_synthetic": (lambda: port_tables.table3_scheme_comparison(
            dataset="synthetic", device="cpu"), R.compare_table3),
        "table4": (lambda: port_tables.table4_fast_reboot(device="cpu"),
                   R.compare_table4),
        "table5": (lambda: port_tables.table5_departure_crossing(
            device="cpu"), R.compare_table5)}[table]
    rows = [list(r) for r in run()]
    lines, failures = compare(rows, ROWS[table])
    assert len(lines) == (2 * len(rows) if table == "table3_synthetic"
                          else len(rows))
    assert not failures, failures
    _same_rows(rows, ROWS[table])


def test_table_functions_take_init_params_and_refuse_an_unknown_seed():
    init = R.reference_init(port_configs.SYNTHETIC_LR, "cpu")
    rows = port_tables.table4_fast_reboot(rounds_after=2, taus=(2,),
                                          device="cpu", init_params=init)
    assert [r[0] for r in rows] == [2]
    with pytest.raises(ValueError, match="seed 0"):
        port_tables._run(port_configs.SYNTHETIC_LR,
                         port_tables._clients_synthetic(3, 0.0, 0.0, 1), "C",
                         1, 1.0, seed=1, device="cpu")


# -- the rules ----------------------------------------------------------------

def _t3(diff_ba, diff_cb, T=4):
    return ["synthetic", "niid", T, 0.5, 0.5 + diff_ba,
            0.5 + diff_ba + diff_cb, diff_ba, diff_cb]


@pytest.mark.parametrize("got,ok", [
    ((0.0, 0.3), True),                      # coincide, sign kept
    ((1e-9, 0.3), False),                    # the schemes no longer coincide
    ((0.0, -0.01), False),                   # a sign beyond the noise flipped
    ((0.0, 0.0), False),                     # ... or vanished
])
def test_table3_rule(got, ok):
    want = [_t3(0.0, 0.3)]
    _, failures = R.compare_table3([_t3(*got)], want)
    assert (not failures) == ok


def test_table3_rule_lists_small_differences_as_noise():
    noise = R.TABLE3_NOISE_SAMPLES / R.TABLE3_N_TEST
    lines, failures = R.compare_table3([_t3(0.2, 0.5 * noise)],
                                       [_t3(0.2, -noise)])
    assert not failures and "within noise" in lines[1]
    _, failures = R.compare_table3([_t3(0.2, -0.5 * noise)],
                                   [_t3(0.2, 2 * noise)])
    assert failures
    with pytest.raises(ValueError):
        R.compare_table3([_t3(0.2, 0.1, T=8)], [_t3(0.2, 0.1)])


@pytest.mark.parametrize("got,ok", [
    ((10, 7, 2), True), ((10, 9, 0), True),
    ((10, 7 + R.EPOCH_TOL + 1, 2), False),
    ((10, 4, 5), False),                     # the order turned
])
def test_table4_rule(got, ok):
    _, failures = R.compare_table4([list(got)], [[10, 7, 2]])
    assert (not failures) == ok


@pytest.mark.parametrize("got,want,ok", [
    (20, 20, True), (20 + R.EPOCH_TOL, 20, True),
    (20 + R.EPOCH_TOL + 1, 20, False), (-1, 20, False), (3, -1, False),
    (-1, -1, True),
])
def test_table5_rule(got, want, ok):
    _, failures = R.compare_table5([[1.0, 1.0, 10, got]],
                                   [[1.0, 1.0, 10, want]])
    assert (not failures) == ok


def test_bound_check_rule():
    want = ROWS["bound_check"]
    assert not R.compare_bound_check([list(r) for r in want], want)[1]
    off = [list(r) for r in want]
    off[3][1] *= 1 + 2 * R.BOUND_RTOL
    assert R.compare_bound_check(off, want)[1]
    outside = [list(r) for r in want]
    outside[5][1] = outside[5][2] * 1.01
    assert R.compare_bound_check(outside, [list(r) for r in outside])[1]
    stuck = [[t, want[0][1], b] for t, _, b in want]
    assert not R.converged(stuck)
    assert R.compare_bound_check(stuck, stuck)[1]
