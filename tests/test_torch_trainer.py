"""Round-for-round parity of the port's FederatedTrainer against the
reference's, with one arrival (fast reboot + LR restart) and one excluding
departure, on the same data, traces, seed and initial parameters.

Plan mode samples participation and batches with the host numpy RNG in the
seed order in both packages, so every RoundRecord's tau, eta, n_active,
s and event must be equal.  Each side draws its data with its own
package's generators (the same arrays, tests/test_torch_theory.py).
Loss, accuracy and parameters are f32 computations in another summation
order: loss rtol 1e-5, parameters rtol 1e-5 / atol 1e-6 after the run."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fed as ref_fed
import repro_torch.fed as port_fed
from repro.configs.paper import EMNIST_CNN, SYNTHETIC_LR
from repro.core.participation import TRACES
from repro.data import synthetic_federation as ref_synthetic_federation
from repro.models.small import init_small, logits_small, make_loss_fn
from repro_torch.configs import paper as port_configs
from repro_torch.core.participation import TRACES as PORT_TRACES
from repro_torch.data import (label_sorted_partition, make_class_dataset,
                              synthetic_federation)
from repro_torch.models import small as port_small
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


PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


def ref_eval(cfg):
    def eval_fn(params, x, y):
        lg = logits_small(params, cfg, x)
        ll = jax.nn.log_softmax(lg)
        loss = -jnp.mean(jnp.take_along_axis(
            ll, y[:, None].astype(jnp.int32), axis=1))
        acc = jnp.mean((jnp.argmax(lg, -1) == y).astype(jnp.float32))
        return float(loss), float(acc)
    return eval_fn


def port_eval(cfg):
    def eval_fn(params, x, y):
        lg = port_small.logits_small(params, cfg, x)
        ll = torch.log_softmax(lg, -1)
        loss = -ll.gather(1, y[:, None].long()).mean()
        return float(loss), float(port_small.accuracy(params, cfg, x, y))
    return eval_fn


def _data(kind, port: bool):
    if kind == "logreg":
        return (synthetic_federation if port else ref_synthetic_federation)(
            0.5, 0.5, 6, seed=0)
    x, y = make_class_dataset(62, 20, seed=0)
    return label_sorted_partition(x, y, 3, seed=0)


def _clients(client_cls, traces, kind):
    train, test = _data(kind, port=client_cls is port_fed.Client)
    rng = np.random.default_rng(0)
    clients = [client_cls(x=tr[0], y=tr[1], trace=traces[rng.integers(0, 8)],
                          x_test=te[0], y_test=te[1])
               for tr, te in zip(train, test)]
    clients[-1].active_from = 1 if kind == "cnn" else 2
    clients[1].departs_at = 2 if kind == "cnn" else 3
    return clients


# (model, engine, agg of both packages, eta0[, scheme, fast_reboot]); the
# scheme is C and fast reboot on unless named
CASES = {
    "logreg-plan": ("logreg", "plan", "tree", 0.5),
    "logreg-plan-flat": ("logreg", "plan", "flat", 0.5),
    "logreg-host": ("logreg", "host", "tree", 0.5),
    "cnn-plan": ("cnn", "plan", "tree", 0.05),
    "logreg-plan-scheme-A": ("logreg", "plan", "tree", 0.5, "A"),
    "logreg-plan-scheme-B": ("logreg", "plan", "tree", 0.5, "B"),
    "logreg-host-scheme-A": ("logreg", "host", "tree", 0.5, "A"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trainer_matches_reference_round_for_round(case):
    kind, engine, agg, eta0, scheme, fast_reboot = \
        (CASES[case] + ("C", True))[:6]
    cfg = SYNTHETIC_LR if kind == "logreg" else EMNIST_CNN
    pcfg = port_configs.PAPER_CONFIGS[cfg.name]
    init = {k: np.asarray(v)
            for k, v in init_small(jax.random.PRNGKey(0), cfg).items()}
    common = dict(local_epochs=5, batch_size=10, scheme=scheme, eta0=eta0,
                  seed=0, engine=engine, agg=agg, fast_reboot=fast_reboot)
    ref = ref_fed.FederatedTrainer(
        loss_fn=make_loss_fn(cfg), eval_fn=ref_eval(cfg),
        init_params={k: jnp.asarray(v) for k, v in init.items()},
        clients=_clients(ref_fed.Client, TRACES, kind), interpret=True,
        **common)
    port = port_fed.FederatedTrainer(
        loss_fn=port_small.make_loss_fn(pcfg), eval_fn=port_eval(pcfg),
        init_params=from_jax(init, pcfg, "cpu"),
        clients=_clients(port_fed.Client, PORT_TRACES, kind), device="cpu",
        **common)
    rounds = 4
    want = ref.run(rounds, eval_every=2)
    got = port.run(rounds, eval_every=2)
    assert len(got) == len(want) == rounds
    assert any(h.event.startswith("arrival") for h in got)
    assert any(h.event.startswith("departure-exclude") for h in got)
    for g, w in zip(got, want):
        assert (g.tau, g.eta, g.n_active, g.event) == \
            (w.tau, w.eta, w.n_active, w.event)
        np.testing.assert_array_equal(g.s, w.s)
        assert np.isnan(g.loss) == np.isnan(w.loss)
        if not np.isnan(w.loss):
            np.testing.assert_allclose(g.loss, w.loss, rtol=1e-5)
            assert g.acc == w.acc
    assert port.objective == ref.objective
    assert port.lr_shift_tau == ref.lr_shift_tau
    got_params = to_numpy(port.params, pcfg)
    for k, v in ref.params.items():
        np.testing.assert_allclose(got_params[k], np.asarray(v), err_msg=k,
                                   **PARAM_TOL)


# (scheme, fast_reboot), held round by round from the reference's params:
# free-running, the vanilla reboot's eval loss drifts 2.0e-5 (relative)
# from the reference's by round 4, f32 summation order past the loss rtol
TEACHER_FORCED = {"scheme-A": ("A", True), "scheme-B": ("B", True),
                  "vanilla-reboot": ("C", False)}


@pytest.mark.parametrize("case", sorted(TEACHER_FORCED))
def test_trainer_matches_reference_teacher_forced(case):
    """Before every round the reference's params are copied into the port;
    the round records, eval losses (rtol 1e-5) and accuracies and the
    params after the round (PARAM_TOL) must agree."""
    scheme, fast_reboot = TEACHER_FORCED[case]
    cfg = SYNTHETIC_LR
    pcfg = port_configs.PAPER_CONFIGS[cfg.name]
    init = {k: np.asarray(v)
            for k, v in init_small(jax.random.PRNGKey(0), cfg).items()}
    common = dict(local_epochs=5, batch_size=10, scheme=scheme, eta0=0.5,
                  seed=0, engine="plan", agg="tree", fast_reboot=fast_reboot)
    ref = ref_fed.FederatedTrainer(
        loss_fn=make_loss_fn(cfg), eval_fn=ref_eval(cfg),
        init_params={k: jnp.asarray(v) for k, v in init.items()},
        clients=_clients(ref_fed.Client, TRACES, "logreg"), interpret=True,
        **common)
    port = port_fed.FederatedTrainer(
        loss_fn=port_small.make_loss_fn(pcfg), eval_fn=port_eval(pcfg),
        init_params=from_jax(init, pcfg, "cpu"),
        clients=_clients(port_fed.Client, PORT_TRACES, "logreg"),
        device="cpu", **common)
    for _ in range(5):
        port.params = from_jax({k: np.asarray(v)
                                for k, v in ref.params.items()}, pcfg, "cpu")
        w = ref.run(1, eval_every=2)[-1]
        g = port.run(1, eval_every=2)[-1]
        assert (g.tau, g.eta, g.n_active, g.event) == \
            (w.tau, w.eta, w.n_active, w.event)
        np.testing.assert_array_equal(g.s, w.s)
        assert np.isnan(g.loss) == np.isnan(w.loss)
        if not np.isnan(w.loss):
            np.testing.assert_allclose(g.loss, w.loss, rtol=1e-5)
            assert g.acc == w.acc
        got = to_numpy(port.params, pcfg)
        for k, v in ref.params.items():
            np.testing.assert_allclose(got[k], np.asarray(v), err_msg=k,
                                       **PARAM_TOL)
    assert any(h.event.startswith("arrival") for h in port.history)
    assert port.reboots if fast_reboot else not port.reboots


def test_plan_engine_resumes_across_run_calls_and_picks_tree_on_cpu():
    """Two run() calls continue the same round clock and RNG stream as one;
    agg='auto' resolves to the per-leaf path on the CPU."""
    pcfg = port_configs.SYNTHETIC_LR
    init = port_small.init_small(pcfg, seed=1, device="cpu")

    def trainer():
        return port_fed.FederatedTrainer(
            loss_fn=port_small.make_loss_fn(pcfg), init_params=init,
            clients=_clients(port_fed.Client, PORT_TRACES, "logreg"),
            eta0=0.5, device="cpu")

    one, two = trainer(), trainer()
    one.run(5)
    two.run(2)
    two.run(3)
    assert two._scheduler.engine.agg == "tree"
    assert [h.tau for h in two.history] == list(range(5))
    for a, b in zip(one.history, two.history):
        assert (a.eta, a.n_active, a.event) == (b.eta, b.n_active, b.event)
    for k in init:
        torch.testing.assert_close(one.params[k], two.params[k], rtol=0,
                                   atol=0)
    # the trainer worked on its own copy of the initial params
    assert not torch.equal(one.params["w"], init["w"])


@pytest.mark.parametrize("engine", ["plan", "host"])
def test_one_client_federation_matches_reference(engine):
    """A federation of one client: equal round records and parameters
    within PARAM_TOL after 3 rounds, as with many clients."""
    cfg = SYNTHETIC_LR
    pcfg = port_configs.PAPER_CONFIGS[cfg.name]
    init = {k: np.asarray(v)
            for k, v in init_small(jax.random.PRNGKey(0), cfg).items()}

    def clients(client_cls, traces):
        make = (synthetic_federation if client_cls is port_fed.Client
                else ref_synthetic_federation)
        (train,), (test,) = make(0.5, 0.5, 1, seed=0)
        return [client_cls(x=train[0], y=train[1], trace=traces[3],
                           x_test=test[0], y_test=test[1])]

    common = dict(local_epochs=5, batch_size=10, scheme="C", eta0=0.5,
                  seed=0, engine=engine)
    ref = ref_fed.FederatedTrainer(
        loss_fn=make_loss_fn(cfg), eval_fn=ref_eval(cfg),
        init_params={k: jnp.asarray(v) for k, v in init.items()},
        clients=clients(ref_fed.Client, TRACES), interpret=True, **common)
    port = port_fed.FederatedTrainer(
        loss_fn=port_small.make_loss_fn(pcfg), eval_fn=port_eval(pcfg),
        init_params=from_jax(init, pcfg, "cpu"),
        clients=clients(port_fed.Client, PORT_TRACES), device="cpu",
        **common)
    want = ref.run(3, eval_every=1)
    got = port.run(3, eval_every=1)
    assert [w.n_active for w in want] == [1, 1, 1]
    for g, w in zip(got, want, strict=True):
        assert (g.tau, g.eta, g.n_active, g.event) == \
            (w.tau, w.eta, w.n_active, w.event)
        np.testing.assert_array_equal(g.s, w.s)
        np.testing.assert_allclose(g.loss, w.loss, rtol=1e-5)
    got_params = to_numpy(port.params, pcfg)
    for k, v in ref.params.items():
        np.testing.assert_allclose(got_params[k], np.asarray(v), err_msg=k,
                                   **PARAM_TOL)


def test_one_client_local_sgd_leaves_the_params_and_equals_a_slice():
    """local_sgd on one client writes its steps into copies, never into
    the params it was given, and its deltas are the first row of the same
    steps on two copies of that client."""
    from repro_torch.core.fed_step import local_sgd
    pcfg = port_configs.SYNTHETIC_LR
    params = port_small.init_small(pcfg, seed=3, device="cpu")
    before = {k: v.clone() for k, v in params.items()}
    rng = np.random.default_rng(4)
    E, B = 3, 5
    batches = {"x": torch.tensor(rng.standard_normal(
                   (1, E, B, pcfg.input_shape[0])).astype(np.float32)),
               "y": torch.tensor(rng.integers(0, pcfg.n_classes, (1, E, B)))}
    alpha = torch.tensor([[1.0, 0.0, 1.0]])
    eta = torch.tensor(0.5)
    one = local_sgd(port_small.make_loss_fn(pcfg), params, batches, alpha,
                    eta)
    for k in params:
        assert torch.equal(params[k], before[k]), k
    two = local_sgd(port_small.make_loss_fn(pcfg), params,
                    {k: v.expand(2, *v.shape[1:]) for k, v in batches.items()},
                    alpha.expand(2, E), eta)
    for k in params:
        assert float(one[k].abs().max()) > 0, k
        assert torch.equal(one[k][0], two[k][0]), k
