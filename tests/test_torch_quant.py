"""The port's compressed round against the reference's.

- ``ops.weighted_agg_quant`` on CPU tensors (its plain version) against the
  reference's Pallas kernel in interpret mode and its ``ref`` oracle, on
  the reference suite's grid (tests/test_kernels.py:89-101) at
  ``ops.TOLERANCE`` (the reference's rtol 1e-5 / atol 1e-6), and its
  refusals of bad shapes;
- the counterpart of the reference's jaxpr walk
  (tests/test_kernels.py:123-150): no op run by the wrapper outputs an f32
  tensor of K*D elements or more;
- ``aggregate_deltas_flat`` on each wire and ``aggregate_deltas_compressed_ref``
  on the same deltas as the reference's, carried across with ``from_jax``:
  the same reference-ordered flat buffer, so the same codes, at the
  aggregation tolerance of tests/test_torch_aggregation.py;
- the trainer on each wire, plan and host engines, teacher-forced: before
  every round the reference's parameters are copied into the port; the
  round records must be equal, and after the round every parameter within
  PARAM_TOL plus one code step per client (see ``_step_bound``);
- ``agg="auto"`` on the CPU: "flat" for a quantized wire, "tree" otherwise.
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
from repro.core import compression as R
from repro.core.aggregation import (aggregate_deltas_compressed_ref,
                                    aggregate_deltas_flat,
                                    flatten_client_deltas)
from repro.core.participation import TRACES
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.models.small import init_small, make_loss_fn
from repro_torch.configs import paper as port_configs
from repro_torch.core import aggregation as port_agg
from repro_torch.core import compression as P
from repro_torch.core.fed_step import local_sgd as port_local_sgd
from repro_torch.core.participation import TRACES as PORT_TRACES
from repro_torch.fed import driver as port_driver
from repro_torch.fed import engine as port_engine
from repro_torch.kernels import ops
from repro_torch.models import small as port_small
from repro_torch.params import from_jax, reference_order, to_numpy

from test_torch_aggregation import AGG_TOL
from test_torch_trainer import PARAM_TOL, _clients, port_eval, ref_eval


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside the other test workers, a pool of
    threads per process oversubscribes the cores, and its idle threads
    spin, slowing every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = ops.TOLERANCE["weighted_agg_quant"][torch.int8]
CONFIGS = {"logreg": SYNTHETIC_LR, "mlp": MNIST_MLP, "cnn": EMNIST_CNN}
WIRES = ("int8", "int8-topk", "bf16")


def _quantized(K, D, chunk, seed=0):
    """The reference suite's inputs: uniform coeffs, normal deltas * 0.3,
    quantized by the reference (tests/test_kernels.py:80-86)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, K).astype(np.float32)
    flat = (rng.normal(size=(K, D)) * 0.3).astype(np.float32)
    payload, scales = R.quantize_chunked(jnp.asarray(flat), chunk=chunk)
    return c, np.asarray(payload), np.asarray(scales)


# -- the kernel's plain version against the Pallas kernel ----------------------

@pytest.mark.parametrize("K", [1, 8, 32, 70])      # 70 > MAX_SINGLE_K
@pytest.mark.parametrize("D,chunk", [(256, 64), (1000, 128), (4096, 256),
                                     (1000, 100)])
def test_weighted_agg_quant_matches_pallas_and_oracle(K, D, chunk):
    c, payload, scales = _quantized(K, D, chunk)
    before = dict(ops.launches)
    got = ops.weighted_agg_quant(torch.tensor(c), torch.tensor(payload),
                                 torch.tensor(scales), chunk=chunk)
    assert ops.launches == before      # a CPU tensor launches no kernel
    assert got.dtype == torch.float32 and got.shape == (payload.shape[1],)
    pallas = ref_ops.weighted_agg_quant(jnp.asarray(c), jnp.asarray(payload),
                                        jnp.asarray(scales), chunk=chunk,
                                        interpret=True)
    oracle = ref_oracles.weighted_agg_quant_ref(
        jnp.asarray(c), jnp.asarray(payload), jnp.asarray(scales),
        chunk=chunk)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_weighted_agg_quant_reads_the_port_quantizers_layout():
    """The port's quantizer pads rows to 16 bytes when Dp is not a multiple
    of 16; the wrapper reads that view as the contiguous payload."""
    rng = np.random.default_rng(3)
    flat = torch.from_numpy(rng.normal(size=(5, 700)).astype(np.float32))
    c = torch.from_numpy(rng.uniform(size=5).astype(np.float32))
    payload, scales = P.quantize_chunked(flat, chunk=100)
    assert payload.stride(0) == 704 and payload.shape == (5, 700)
    got = ops.weighted_agg_quant(c, payload, scales, chunk=100)
    want = ops.weighted_agg_quant(c, payload.contiguous(), scales,
                                  chunk=100)
    assert torch.equal(got, want)


def test_weighted_agg_quant_rejects_bad_shapes():
    c, payload, scales = (torch.tensor(a) for a in _quantized(4, 512, 128))
    with pytest.raises(ValueError, match="scales shape"):
        ops.weighted_agg_quant(c, payload, scales[:, :-1], chunk=128)
    with pytest.raises(ValueError, match="not a multiple of the scale chunk"):
        ops.weighted_agg_quant(c, payload[:, :-1], scales, chunk=128)
    # the reference refuses the same two
    with pytest.raises(ValueError):
        ref_ops.weighted_agg_quant(jnp.asarray(c.numpy()),
                                   jnp.asarray(payload.numpy()),
                                   jnp.asarray(scales.numpy()[:, :-1]),
                                   chunk=128)
    with pytest.raises(ValueError):
        ref_ops.weighted_agg_quant(jnp.asarray(c.numpy()),
                                   jnp.asarray(payload.numpy()[:, :-1]),
                                   jnp.asarray(scales.numpy()), chunk=128)
    with pytest.raises(TypeError):
        ops.weighted_agg_quant(c, payload.float(), scales, chunk=128)


class _Outputs(TorchDispatchMode):
    """Records the dtype and size of every tensor each op outputs."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.seen.append((str(func), t.dtype, t.numel()))
        return out


def test_weighted_agg_quant_never_materializes_f32_deltas():
    """No op run by the wrapper outputs an f32 tensor of the (K, D)
    payload's size: the codes are dequantized a row at a time."""
    K, D, chunk = 8, 4096, 256
    c, payload, scales = (torch.tensor(a) for a in _quantized(K, D, chunk))
    with _Outputs() as mode:
        ops.weighted_agg_quant(c, payload, scales, chunk=chunk)
    assert len(mode.seen) > K          # the mode saw the per-row ops
    big = [s for s in mode.seen if s[1] == torch.float32 and s[2] >= K * D]
    assert not big, big


# -- the compressed aggregation ------------------------------------------------

def _deltas(cfg, C, seed):
    rng = np.random.default_rng(seed)
    params = {k: np.asarray(v) for k, v in
              init_small(jax.random.PRNGKey(seed), cfg).items()}
    deltas = {k: (1e-2 * rng.normal(size=(C, *v.shape))).astype(np.float32)
              for k, v in params.items()}
    return params, deltas


def _port_deltas(deltas, pcfg):
    """Client-stacked deltas in the reference's layout -> the port's,
    converted client by client with ``from_jax``."""
    C = next(iter(deltas.values())).shape[0]
    rows = [from_jax({k: v[c] for k, v in deltas.items()}, pcfg, "cpu")
            for c in range(C)]
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_compressed_aggregation_matches_reference(kind, wire):
    """The reference's own deltas and params carried across with
    ``from_jax`` (the CNN's into the port's layout): the wire gathers the
    flat buffer into the reference's order, so the same chunk grid and the
    same codes."""
    cfg = CONFIGS[kind]
    pcfg = port_configs.PAPER_CONFIGS[cfg.name]
    params, deltas = _deltas(cfg, 4, seed=5)
    coeffs = np.array([0.5, 0.0, 1.25, 0.3], np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jd = {k: jnp.asarray(v) for k, v in deltas.items()}
    want_flat = aggregate_deltas_flat(jp, jd, jnp.asarray(coeffs),
                                      interpret=True, compression=wire)
    want_ref = aggregate_deltas_compressed_ref(jp, jd, jnp.asarray(coeffs),
                                               wire)

    def port(fn, **kw):
        return to_numpy(fn(from_jax(params, pcfg, "cpu"),
                           _port_deltas(deltas, pcfg),
                           torch.from_numpy(coeffs), **kw), pcfg)
    got_flat = port(port_agg.aggregate_deltas_flat, compression=wire,
                    model_kind=pcfg.kind)
    got_ref = port(port_agg.aggregate_deltas_compressed_ref,
                   compression=wire, model_kind=pcfg.kind)
    for got, want in ((got_flat, want_flat), (got_ref, want_ref),
                      (got_flat, want_ref)):
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       err_msg=k, **AGG_TOL)


@pytest.mark.parametrize("wire", ["int8", "int8-topk", "int8:chunk=100"])
@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_wire_payload_and_scales_equal_the_reference_bit_for_bit(kind,
                                                                  wire):
    """On the same deltas, carried across with ``from_jax``, the port's
    wire buffer holds the reference's flat buffer element for element, and
    its payload and scales are the reference's bit for bit (the CNN's
    included, whose layout differs)."""
    cfg = CONFIGS[kind]
    pcfg = port_configs.PAPER_CONFIGS[cfg.name]
    params, deltas = _deltas(cfg, 4, seed=9)
    ref_flat = flatten_client_deltas({k: jnp.asarray(v)
                                      for k, v in deltas.items()})
    ref_payload, ref_scales = R.compress_flat(ref_flat,
                                              R.resolve_compression(wire))
    spec = P.resolve_compression(wire)
    port_params = from_jax(params, pcfg, "cpu")
    flat, inverse = port_agg.flatten_for_wire(
        port_params, _port_deltas(deltas, pcfg), spec, pcfg.kind)
    assert (inverse is None) == (kind != "cnn")
    # the order comes from the model's kind, not from its leaves' names
    assert reference_order(port_params, "mlp") is None
    assert torch.equal(flat, torch.tensor(np.asarray(ref_flat)))
    payload, scales = P.compress_flat(flat, spec)
    np.testing.assert_array_equal(payload.numpy(), np.asarray(ref_payload))
    np.testing.assert_array_equal(scales.numpy().view(np.int32),
                                  np.asarray(ref_scales).view(np.int32))
    # the inverse gather takes the reference's order back to the port's
    if inverse is not None:
        port_flat = port_agg.flatten_client_deltas(_port_deltas(deltas, pcfg))
        assert torch.equal(flat[:, inverse], port_flat)


@pytest.mark.parametrize("wire", ["int8", "int8-topk"])
def test_flat_quantized_aggregation_launches_weighted_agg_quant_once(
        wire, monkeypatch):
    calls = []
    real = ops.weighted_agg_quant
    monkeypatch.setattr(ops, "weighted_agg_quant",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    params, deltas = _deltas(SYNTHETIC_LR, 3, seed=6)
    port_agg.aggregate_deltas_flat(
        {k: torch.tensor(v) for k, v in params.items()},
        {k: torch.tensor(v) for k, v in deltas.items()},
        torch.ones(3), compression=wire)
    assert calls == [{"chunk": 256}]


# -- the trainer, teacher-forced -----------------------------------------------

def _bf16_spacing(x: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8).masked_fill_(x == 0, 0.0)


def _steps(spec, flat: torch.Tensor) -> torch.Tensor:
    """Per client and element of a flat (C, D) delta buffer in the wire's
    order: its code step on the wire, the scale of its chunk (int8) or the
    bf16 spacing at it."""
    if spec.quantized:
        scales = P.compress_flat(flat, spec)[1]
        return scales.repeat_interleave(spec.chunk, 1)[:, :flat.shape[1]]
    return _bf16_spacing(flat)


def _step_bound(wire, pcfg, call) -> torch.Tensor:
    """sum_k |c_k| * step_k(d) over the round's clients, in the port's flat
    order: the most that one flipped rounding per client can move element
    d of the update when the two packages quantize deltas that agree to
    f32 noise.  step_k(d) is the port's own step: both packages cut the
    same reference-ordered buffer into the same chunks."""
    spec = P.resolve_compression(wire)
    params, batches, alpha, coeffs, eta = call
    port_deltas = port_local_sgd(port_small.make_loss_fn(pcfg), params,
                                 batches, alpha, eta)
    flat, inverse = port_agg.flatten_for_wire(params, port_deltas, spec,
                                              pcfg.kind)
    steps = _steps(spec, flat)
    if inverse is not None:
        steps = steps[:, inverse]
    return coeffs.abs() @ steps


def _port_flat(params) -> torch.Tensor:
    return torch.cat([params[k].reshape(-1) for k in sorted(params)])


# (model, engine, eta0): the trainer tests' cases, on each wire
TRAINER_CASES = {"logreg-plan": ("logreg", "plan", 0.5),
                 "logreg-host": ("logreg", "host", 0.5),
                 "cnn-plan": ("cnn", "plan", 0.05),
                 "cnn-host": ("cnn", "host", 0.05)}


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("case", sorted(TRAINER_CASES))
def test_compressed_trainer_matches_reference_round_for_round(case, wire,
                                                              monkeypatch):
    kind, engine, eta0 = TRAINER_CASES[case]
    cfg = SYNTHETIC_LR if kind == "logreg" else EMNIST_CNN
    pcfg = port_configs.PAPER_CONFIGS[cfg.name]
    init = {k: np.asarray(v)
            for k, v in init_small(jax.random.PRNGKey(0), cfg).items()}
    common = dict(local_epochs=5, batch_size=10, scheme="C", eta0=eta0,
                  seed=0, engine=engine, compression=wire)
    ref = ref_fed.FederatedTrainer(
        loss_fn=make_loss_fn(cfg), eval_fn=ref_eval(cfg),
        init_params={k: jnp.asarray(v) for k, v in init.items()},
        clients=_clients(ref_fed.Client, TRACES, kind), interpret=True,
        **common)
    port = port_fed.FederatedTrainer(
        loss_fn=port_small.make_loss_fn(pcfg), eval_fn=port_eval(pcfg),
        init_params=from_jax(init, pcfg, "cpu"),
        clients=_clients(port_fed.Client, PORT_TRACES, kind), device="cpu",
        model_kind=pcfg.kind, **common)
    # the inputs of each port round, for its step bound
    calls = []
    real = port_engine.fed_round_parallel

    def spy(loss_fn, params, batches, alpha, coeffs, eta, **kw):
        calls.append(({k: v.clone() for k, v in params.items()}, batches,
                      alpha, coeffs, eta))
        return real(loss_fn, params, batches, alpha, coeffs, eta, **kw)
    monkeypatch.setattr(port_engine, "fed_round_parallel", spy)
    monkeypatch.setattr(port_driver, "fed_round_parallel", spy)

    for tau in range(4):
        start = {k: np.asarray(v) for k, v in ref.params.items()}
        port.params = from_jax(start, pcfg, "cpu")      # teacher forcing
        w = ref.run(1, eval_every=2)[-1]
        g = port.run(1, eval_every=2)[-1]
        assert (g.tau, g.eta, g.n_active, g.event) == \
            (w.tau, w.eta, w.n_active, w.event)
        np.testing.assert_array_equal(g.s, w.s)
        assert np.isnan(g.loss) == np.isnan(w.loss)
        assert np.isnan(g.loss) or np.isfinite(g.loss)
        assert len(calls) == tau + 1
        if wire == "int8-topk":
            # one element crossing the top-k threshold moves by up to the
            # threshold: the records and finite losses are the check
            continue
        got = _port_flat(port.params)
        want = _port_flat(from_jax({k: np.asarray(v)
                                    for k, v in ref.params.items()},
                                   pcfg, "cpu"))
        diff = (got - want).abs()
        tol = PARAM_TOL["atol"] + PARAM_TOL["rtol"] * want.abs()
        bound = _step_bound(wire, pcfg, calls[-1])
        # f32 noise as in the f32 round, plus the flipped roundings
        assert bool((diff <= tol + bound).all()), \
            float((diff - tol - bound).max())
    assert any(h.event.startswith("arrival") for h in port.history)
    assert any(h.event.startswith("departure-exclude")
               for h in port.history)


@pytest.mark.parametrize("wire,want", [("none", "tree"), ("bf16", "tree"),
                                       ("int8", "flat"),
                                       ("int8-topk", "flat")])
def test_auto_agg_on_the_cpu_follows_the_wire(wire, want):
    pcfg = port_configs.SYNTHETIC_LR
    clients = _clients(port_fed.Client, PORT_TRACES, "logreg")
    engine = port_fed.RoundEngine(
        loss_fn=port_small.make_loss_fn(pcfg), clients=clients,
        local_epochs=2, batch_size=2, device="cpu", compression=wire)
    assert engine.agg == want
    assert engine.compression == P.resolve_compression(wire)
    trainer = port_fed.FederatedTrainer(
        loss_fn=port_small.make_loss_fn(pcfg),
        init_params=port_small.init_small(pcfg, device="cpu"),
        clients=clients, device="cpu", compression=wire)
    trainer.run(1)
    assert trainer._scheduler.engine.agg == want
    assert trainer._scheduler.engine.compression is trainer.compression
