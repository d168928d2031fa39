"""The port's client-sequential round against the reference's, and against
its own client-parallel round.

- ``accumulate_delta`` / ``apply_accumulator``: bit for bit the reference's
  (the product and the sum rounded each on its own);
- ``round_trip_tree`` on each wire: one client's delta bit for bit the
  reference's, and its row of the parallel path's round-tripped buffer (the
  same element order and chunk grid, the CNN's included);
- the trainer with ``mode="client_sequential"``, teacher-forced against the
  reference's ``FederatedTrainer(mode="client_sequential",
  engine="plan")`` for the three paper models, f32 and int8: equal round
  records, and after every round each parameter within PARAM_TOL (int8:
  plus one code step per client, as ``tests/test_torch_quant.py``);
- int8 and f32 client-sequential equal to client-parallel on the flat path
  bit for bit, for logreg, the MLP and the CNN.  These run at one intra-op
  thread: at more, the CPU's BLAS splits the product of a single client's
  (B, K) by (K, N) matrices over its threads and sums in another order than
  the same product inside a batch of clients, so a one-client local step
  is then another summation order (``test_one_client_steps_*``);
- the memory contract: no op of the sequential round outputs a C-fold
  copy of the params or a (C, D_total) buffer;
- ``RoundEngine(mode=)``'s refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.fed as ref_fed
import repro_torch.fed as port_fed
from repro.configs.paper import EMNIST_CNN, MNIST_MLP, SYNTHETIC_LR
from repro.core import aggregation as ref_agg
from repro.core import compression as R
from repro.core.participation import TRACES
from repro.data import (label_sorted_partition as ref_label_sorted,
                        make_class_dataset as ref_class_dataset,
                        synthetic_federation as ref_synthetic)
from repro.models.small import init_small, make_loss_fn
from repro_torch.configs import paper as port_configs
from repro_torch.core import aggregation as port_agg
from repro_torch.core import compression as P
from repro_torch.core.fed_step import (fed_round_parallel,
                                       fed_round_sequential, local_sgd)
from repro_torch.core.participation import TRACES as PORT_TRACES
from repro_torch.data import (label_sorted_partition, make_class_dataset,
                              synthetic_federation)
from repro_torch.fed import engine as port_engine
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


CONFIGS = {"logreg": SYNTHETIC_LR, "mlp": MNIST_MLP, "cnn": EMNIST_CNN}


@pytest.fixture
def one_thread():
    """One intra-op thread for the bit-for-bit comparisons of a one-client
    local step with its row of a batch of clients (module docstring)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(kind, synthetic, class_dataset, label_sorted):
    """The reference's int8 modes scenario for logreg (4 clients of
    SYNTHETIC(0.5, 0.5)); three label-sorted clients for the image
    models."""
    if kind == "logreg":
        return synthetic(0.5, 0.5, 4, seed=0)
    x, y = class_dataset(CONFIGS[kind].n_classes, 20, seed=0)
    return label_sorted(x, y, 3, seed=0)


def _clients(client_cls, traces, kind, port: bool):
    if port:
        train, test = _data(kind, synthetic_federation, make_class_dataset,
                            label_sorted_partition)
    else:
        train, test = _data(kind, ref_synthetic, ref_class_dataset,
                            ref_label_sorted)
    rng = np.random.default_rng(0)
    return [client_cls(x=tr[0], y=tr[1], trace=traces[rng.integers(0, 8)],
                       x_test=te[0], y_test=te[1])
            for tr, te in zip(train, test)]


def _init(cfg):
    return {k: np.asarray(v)
            for k, v in init_small(jax.random.PRNGKey(0), cfg).items()}


# -- the streaming accumulator and the one-client wire ------------------------

def test_accumulate_and_apply_are_the_references():
    rng = np.random.default_rng(0)
    shapes = {"a": (50, 40), "b": (7,)}
    acc, delta, params = ({k: rng.standard_normal(s).astype(np.float32)
                           for k, s in shapes.items()} for _ in range(3))
    c = np.float32(0.3712)
    want = ref_agg.apply_accumulator(
        {k: jnp.asarray(v) for k, v in params.items()},
        ref_agg.accumulate_delta({k: jnp.asarray(v) for k, v in acc.items()},
                                 {k: jnp.asarray(v)
                                  for k, v in delta.items()}, c))
    got_acc = port_agg.accumulate_delta(
        {k: torch.tensor(v) for k, v in acc.items()},
        {k: torch.tensor(v) for k, v in delta.items()}, torch.tensor(c))
    got = port_agg.apply_accumulator(
        {k: torch.tensor(v) for k, v in params.items()}, got_acc)
    for k in shapes:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # a Python coefficient takes the same path
    again = port_agg.accumulate_delta(
        {k: torch.tensor(v) for k, v in acc.items()},
        {k: torch.tensor(v) for k, v in delta.items()}, float(c))
    for k in shapes:
        assert torch.equal(again[k], got_acc[k])


@pytest.mark.parametrize("wire", ["none", "int8", "int8-topk", "bf16",
                                  "int8:chunk=100"])
@pytest.mark.parametrize("kind", ["logreg", "cnn"])
def test_round_trip_tree_is_the_references_and_the_parallel_row(kind, wire):
    cfg = CONFIGS[kind]
    pcfg = port_configs.PAPER_CONFIGS[cfg.name]
    rng = np.random.default_rng(1)
    C = 3
    stacked = {k: (1e-2 * rng.normal(size=(C, *v.shape))).astype(np.float32)
               for k, v in _init(cfg).items()}
    spec = P.resolve_compression(wire)
    port_stacked = {k: torch.stack([from_jax(
        {n: stacked[n][c] for n in stacked}, pcfg, "cpu")[k]
        for c in range(C)]) for k in stacked}
    # the parallel path's round trip of the whole (C, D) buffer
    flat, inverse = port_agg.flatten_for_wire(
        {k: v[0] for k, v in port_stacked.items()}, port_stacked, spec,
        pcfg.kind)
    rows = P.round_trip(flat, spec)
    if inverse is not None:
        rows = rows[:, inverse]
    for c in range(C):
        one = {k: v[c] for k, v in port_stacked.items()}
        got = P.round_trip_tree(one, spec, pcfg.kind)
        want = R.round_trip_tree({k: jnp.asarray(v[c])
                                  for k, v in stacked.items()},
                                 R.resolve_compression(wire))
        got_ref = to_numpy(got, pcfg)
        for k in stacked:
            np.testing.assert_array_equal(got_ref[k], np.asarray(want[k]),
                                          err_msg=f"{k} client {c}")
        assert torch.equal(_port_flat(got), rows[c])


# -- the trainer, teacher-forced against the reference ------------------------

@pytest.mark.parametrize("wire", [None, "int8"])
@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_sequential_trainer_matches_reference_round_for_round(kind, wire,
                                                              monkeypatch):
    cfg = CONFIGS[kind]
    pcfg = port_configs.PAPER_CONFIGS[cfg.name]
    init = _init(cfg)
    eta0 = 0.5 if kind == "logreg" else 0.05
    common = dict(local_epochs=3, batch_size=10, scheme="C", eta0=eta0,
                  seed=0, engine="plan", compression=wire,
                  mode="client_sequential")
    ref = ref_fed.FederatedTrainer(
        loss_fn=make_loss_fn(cfg), eval_fn=ref_eval(cfg),
        init_params={k: jnp.asarray(v) for k, v in init.items()},
        clients=_clients(ref_fed.Client, TRACES, kind, port=False),
        interpret=True, **common)
    port = port_fed.FederatedTrainer(
        loss_fn=port_small.make_loss_fn(pcfg), eval_fn=port_eval(pcfg),
        init_params=from_jax(init, pcfg, "cpu"),
        clients=_clients(port_fed.Client, PORT_TRACES, kind, port=True),
        device="cpu", model_kind=pcfg.kind, **common)
    calls = []
    real = port_engine.fed_round_sequential

    def spy(loss_fn, params, batches, alpha, coeffs, eta, **kw):
        calls.append(({k: v.clone() for k, v in params.items()}, batches,
                      alpha, coeffs, eta))
        return real(loss_fn, params, batches, alpha, coeffs, eta, **kw)
    monkeypatch.setattr(port_engine, "fed_round_sequential", spy)

    rounds = 2 if kind == "cnn" else 3
    for tau in range(rounds):
        start = {k: np.asarray(v) for k, v in ref.params.items()}
        port.params = from_jax(start, pcfg, "cpu")      # teacher forcing
        w = ref.run(1, eval_every=2)[-1]
        g = port.run(1, eval_every=2)[-1]
        assert (g.tau, g.eta, g.n_active, g.event) == \
            (w.tau, w.eta, w.n_active, w.event)
        np.testing.assert_array_equal(g.s, w.s)
        assert np.isnan(g.loss) == np.isnan(w.loss)
        if not np.isnan(w.loss):
            np.testing.assert_allclose(g.loss, w.loss, rtol=1e-5)
        assert len(calls) == tau + 1
        got = _port_flat(port.params)
        want = _port_flat(from_jax({k: np.asarray(v) for k, v in
                                    ref.params.items()}, pcfg, "cpu"))
        bound = (_step_bound(wire, pcfg, calls[-1]) if wire
                 else torch.zeros_like(got))
        tol = PARAM_TOL["atol"] + PARAM_TOL["rtol"] * want.abs()
        excess = (got - want).abs() - tol - bound
        assert float(excess.max()) <= 0, (tau, float(excess.max()))


# -- client-sequential against client-parallel, bit for bit -------------------

@pytest.mark.parametrize("wire", [None, "int8"])
@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_sequential_equals_flat_parallel_bit_for_bit(kind, wire, one_thread):
    """The reference's sharp invariant (tests/test_compression.py:180), in
    plan mode: both modes quantize each client on the same flat layout and
    sum c_k * delta_k from zero in the order k = 0..C-1, so the params and
    records are equal to the bit; on f32 too."""
    cfg = port_configs.PAPER_CONFIGS[CONFIGS[kind].name]
    runs = {}
    for mode, agg in (("client_parallel", "flat"),
                      ("client_sequential", "auto")):
        runs[mode] = port_fed.FederatedTrainer(
            loss_fn=port_small.make_loss_fn(cfg),
            init_params=port_small.init_small(cfg, seed=0, device="cpu"),
            clients=_clients(port_fed.Client, PORT_TRACES, kind, port=True),
            local_epochs=3, batch_size=10, eta0=0.5 if kind == "logreg"
            else 0.05, seed=0, device="cpu", agg=agg, compression=wire,
            model_kind=cfg.kind, mode=mode)
        runs[mode].run(4 if kind == "cnn" else 8, eval_every=4)
    par, seq = runs["client_parallel"], runs["client_sequential"]
    for a, b in zip(seq.history, par.history, strict=True):
        assert (a.tau, a.eta, a.n_active, a.event) == \
            (b.tau, b.eta, b.n_active, b.event)
        np.testing.assert_array_equal(a.s, b.s)
    for k in par.params:
        assert torch.equal(seq.params[k], par.params[k]), k
    assert not torch.equal(seq.params[sorted(par.params)[0]],
                           port_small.init_small(cfg, seed=0,
                                                 device="cpu")[
                               sorted(par.params)[0]])


def _round_inputs(cfg, C, E=3, B=10, seed=4):
    rng = np.random.default_rng(seed)
    batches = {"x": torch.tensor(rng.standard_normal(
                   (C, E, B, *cfg.input_shape)).astype(np.float32)),
               "y": torch.tensor(rng.integers(0, cfg.n_classes, (C, E, B)))}
    alpha = torch.tensor((rng.random((C, E)) < 0.7).astype(np.float32))
    coeffs = torch.tensor(rng.random(C).astype(np.float32))
    return batches, alpha, coeffs, torch.tensor(0.05)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_one_client_steps_equal_their_row_at_one_thread(kind, one_thread):
    cfg = port_configs.PAPER_CONFIGS[CONFIGS[kind].name]
    params = port_small.init_small(cfg, seed=2, device="cpu")
    batches, alpha, _, eta = _round_inputs(cfg, 4)
    loss = port_small.make_loss_fn(cfg)
    rows = local_sgd(loss, params, batches, alpha, eta)
    for c in range(4):
        one = local_sgd(loss, params, {k: v[c:c + 1]
                                       for k, v in batches.items()},
                        alpha[c:c + 1], eta)
        for k in rows:
            assert torch.equal(one[k][0], rows[k][c]), (k, c)


class _Largest(TorchDispatchMode):
    """The largest number of elements of any tensor an op outputs."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


@pytest.mark.parametrize("wire", [None, "int8"])
def test_sequential_round_never_holds_a_client_stack(wire):
    """Only the params, the accumulator and one client's delta exist: no op
    outputs twice the model's elements (the largest output is one client's
    flat wire row, padded to whole chunks), while the parallel round's flat
    buffer holds C clients."""
    cfg = port_configs.MNIST_MLP
    C = 6
    params = port_small.init_small(cfg, seed=0, device="cpu")
    D = sum(p.numel() for p in params.values())
    batches, alpha, coeffs, eta = _round_inputs(cfg, C)
    loss = port_small.make_loss_fn(cfg)
    with _Largest() as seq:
        fed_round_sequential(loss, {k: v.clone() for k, v in params.items()},
                             batches, alpha, coeffs, eta, compression=wire,
                             model_kind=cfg.kind)
    with _Largest() as par:
        fed_round_parallel(loss, {k: v.clone() for k, v in params.items()},
                           batches, alpha, coeffs, eta, agg="flat",
                           compression=wire, model_kind=cfg.kind)
    assert seq.largest < 2 * D and par.largest >= C * D


def test_engine_refuses_an_unknown_mode_and_a_sharded_sequential_round():
    cfg = port_configs.SYNTHETIC_LR
    clients = _clients(port_fed.Client, PORT_TRACES, "logreg", port=True)
    kw = dict(loss_fn=port_small.make_loss_fn(cfg), clients=clients,
              local_epochs=2, batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="client_parallel"):
        port_fed.RoundEngine(mode="client_serial", **kw)
    with pytest.raises(ValueError, match="ROADMAP item 6"):
        port_fed.RoundEngine(mode="client_sequential", sharding=object(),
                             **kw)
    assert port_fed.RoundEngine(mode="client_sequential",
                                **kw).mode == "client_sequential"
