#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's federated round on one CUDA card.

    python3 chip_smoke.py

Run it from the root of a checkout: it imports ``src/repro_torch`` beside
it, and nothing of JAX or of the JAX package.  In order it

1. prints the card (name and power limit, as nvidia-smi gives them), the
   torch and CUDA versions and the two TF32 flags;
2. builds the hand-written kernels from ``src/repro_torch/kernels/csrc``;
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes, at the tolerances of ``repro_torch.kernels.ops``;
4. drives the main path, ``FederatedTrainer(engine="plan")`` on the EMNIST
   CNN at full width with 62 clients, through one late arrival and one
   excluding departure; checks each kernel's launch count, finite eval
   losses, and the card's parameters against the port's plain path (the
   same trainer on the CPU); then times warm rounds and profiles two;
5. times each kernel beside its bound, its plain version and the one
   PyTorch call that computes the same function, and prints them as one
   ``{"kernels": [...]}`` line.

Any failure raises and the script exits nonzero.  The last line,
``{"ok": true, "device": {...}}``, is printed only when every phase passed.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA's data sheet): device memory and f32 outside the
# tensor cores; both kernels work in f32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

N_CLIENTS = 62          # EMNIST_CNN.n_devices
ROUNDS = 6              # main path: arrival at TAU_ARRIVE, departure at
TAU_ARRIVE = 2          # TAU_DEPART, eval every EVAL_EVERY rounds
TAU_DEPART = 4
EVAL_EVERY = 2
WARM_ROUNDS = 10
PROFILED_ROUNDS = 2
NO_EVAL = 10 ** 9
# card against the CPU after ROUNDS rounds: f32 in another summation order
# (cuDNN and cuBLAS against the CPU's convolutions and matmuls)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-5


def log(*args) -> None:
    print(*args, flush=True)


def import_port():
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise SystemExit(f"chip_smoke.py: no src/repro_torch beside "
                         f"{Path(__file__).name}; run it from the root of a "
                         f"checkout of the repository")
    sys.path.insert(0, str(src))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


# -- 3. each kernel against its plain version ---------------------------------
def check_weighted_agg(dev, D: int) -> float:
    from repro_torch.kernels import ops
    from repro_torch.kernels.weighted_agg import padded, weighted_agg_plain
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    # the main path's shape in f32 (D = 2 mod 4: the last vector of a row
    # is half pad) and bf16 (D = 6 mod 8); rows of whole vectors with no
    # pad, passed as a plain contiguous tensor; a tail of 3 columns; and
    # K > 64 (the reference's K-tiled layout)
    for K, n, dtype in [(N_CLIENTS, D, torch.float32),
                        (N_CLIENTS, D, torch.bfloat16),
                        (N_CLIENTS, D + 2, torch.float32),
                        (N_CLIENTS, D + 1, torch.float32),
                        (100, D, torch.float32)]:
        c = torch.rand(K, device=dev, generator=gen)
        c[::7] = 0.0                          # clients with no work
        d = padded(torch.randn(K, n, device=dev, generator=gen).to(dtype))
        if n % 4 == 0:
            d = d.contiguous()
        got = ops.weighted_agg(c, d)
        want = weighted_agg_plain(c, d)
        torch.cuda.synchronize()
        tol = ops.TOLERANCE["weighted_agg"][dtype]
        err = max_abs_err(got, want)
        log(f"  weighted_agg K={K} D={n} {dtype}: max_abs_err {err:.3e} "
            f"(rtol {tol['rtol']:g}, atol {tol['atol']:g})")
        torch.testing.assert_close(got, want, **tol)
        worst = max(worst, err)
    return worst


def check_masked_sgd(dev, leaves) -> float:
    from repro_torch.kernels import ops
    from repro_torch.kernels.masked_sgd import masked_sgd_plain
    gen = torch.Generator(device=dev).manual_seed(1)
    tol = ops.TOLERANCE["masked_sgd"][torch.float32]
    worst = 0.0
    D = sum(leaves.values())
    # one local step's launches: every leaf as (clients, n) with a scale
    # per client (zeros: masked steps), then the Pallas kernel's scalar form
    cases = [(name, (N_CLIENTS, n)) for name, n in leaves.items()]
    cases.append(("scalar form", (D,)))
    for name, shape in cases:
        w = torch.randn(*shape, device=dev, generator=gen)
        g = torch.randn(*shape, device=dev, generator=gen)
        rows = shape[0] if len(shape) == 2 else 1
        s = 5e-4 * (torch.rand(rows, device=dev, generator=gen) < 0.8)
        got = ops.masked_sgd(w.clone(), g, s)
        want = masked_sgd_plain(w.clone(), g, s)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        log(f"  masked_sgd {name} {tuple(shape)} f32: max_abs_err {err:.3e} "
            f"(rtol {tol['rtol']:g}, atol {tol['atol']:g})")
        torch.testing.assert_close(got, want, **tol)
        worst = max(worst, err)
    return worst


# -- 4. the main path -----------------------------------------------------------
def make_clients(n_clients: int = N_CLIENTS, seed: int = 0):
    """The paper's EMNIST federation, synthetic and seeded: label-sorted
    non-IID shards with Pareto sample counts, a Table-2 trace per client,
    the last client arriving at TAU_ARRIVE and client 3 leaving at
    TAU_DEPART under the exclude policy."""
    from repro_torch.configs.paper import EMNIST_CNN
    from repro_torch.core.participation import TRACES
    from repro_torch.data import label_sorted_partition, make_class_dataset
    from repro_torch.fed import Client
    x, y = make_class_dataset(EMNIST_CNN.n_classes, 100, seed=seed)
    x = x[..., None]                                  # (N, 28, 28, 1)
    train, test = label_sorted_partition(x, y, n_clients, seed=seed)
    rng = np.random.default_rng(seed)
    clients = [Client(x=tr[0], y=tr[1], trace=TRACES[rng.integers(0, 8)],
                      x_test=te[0], y_test=te[1])
               for tr, te in zip(train, test)]
    clients[-1].active_from = TAU_ARRIVE
    clients[3].departs_at = TAU_DEPART
    clients[3].departure_policy = "exclude"
    return clients


def make_trainer(clients, device, agg: str = "auto"):
    from repro_torch.configs.paper import EMNIST_CNN as cfg
    from repro_torch.fed import FederatedTrainer
    from repro_torch.models.small import (init_small, logits_small,
                                          make_loss_fn)

    def eval_fn(params, x, y):
        ll = torch.log_softmax(logits_small(params, cfg, x), -1)
        loss = -ll.gather(1, y[:, None].long()).mean()
        acc = (ll.argmax(-1) == y).float().mean()
        return float(loss), float(acc)

    return FederatedTrainer(
        loss_fn=make_loss_fn(cfg), eval_fn=eval_fn,
        init_params=init_small(cfg, seed=0, device=device), clients=clients,
        local_epochs=cfg.local_epochs, batch_size=cfg.batch_size,
        scheme="C", eta0=cfg.eta0, seed=0, engine="plan", agg=agg,
        device=device)


def check_history(history) -> None:
    events = "".join(h.event for h in history)
    if "arrival:" not in events or "departure-exclude:" not in events:
        raise RuntimeError(f"the main path saw events {events!r}; expected "
                           f"an arrival and an excluding departure")
    evals = [h for h in history if not math.isnan(h.loss)]
    if len(evals) < ROUNDS // EVAL_EVERY:
        raise RuntimeError(f"{len(evals)} eval rounds in {ROUNDS}")
    if not all(math.isfinite(h.loss) and math.isfinite(h.acc)
               for h in evals):
        raise RuntimeError("non-finite eval loss on the main path")


def compare_with_plain(card, plain) -> float:
    """The card's run against the same run on the CPU: equal records,
    eval losses within LOSS_RTOL and parameters within PARAM_TOL."""
    for a, b in zip(card.history, plain.history, strict=True):
        if (a.tau, a.eta, a.n_active, a.event) != \
                (b.tau, b.eta, b.n_active, b.event) \
                or not np.array_equal(a.s, b.s):
            raise RuntimeError(f"round records differ at tau={a.tau}")
        if math.isnan(a.loss) != math.isnan(b.loss) or (
                not math.isnan(a.loss)
                and abs(a.loss - b.loss) > LOSS_RTOL * abs(b.loss)):
            raise RuntimeError(f"eval loss {a.loss} on the card, {b.loss} "
                               f"on the CPU at tau={a.tau}")
    worst = 0.0
    for name, p in plain.params.items():
        got = card.params[name].cpu()
        worst = max(worst, max_abs_err(got, p))
        torch.testing.assert_close(got, p, **PARAM_TOL, msg=name)
    return worst


def profile_rounds(trainer, n: int) -> None:
    """Kernel time by name over n warm rounds, and the card's busy share:
    the union of kernel intervals over the host's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run(n, eval_every=NO_EVAL)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        # the profile only reports where the time goes; the phases above
        # hold the path and the kernels
        log(f"  profile of {n} warm rounds: the profiler recorded no kernel "
            f"on the card, no breakdown")
        return
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    busy, end = 0.0, -math.inf
    for s, e in sorted((k.time_range.start, k.time_range.end)
                       for k in kernels):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    total = sum(t for t, _ in by_name.values())
    log(f"  profile of {n} warm rounds: wall {wall_us / 1e3:.3f} ms under "
        f"the profiler, kernels {total / 1e3:.3f} ms summed, "
        f"{busy / 1e3:.3f} ms busy ({100 * busy / wall_us:.1f}% of wall)")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"    {t / 1e3:9.3f} ms {c:6d}x  {name[:100]}")


def main_path(dev):
    from repro_torch.kernels import ops
    clients = make_clients()
    trainer = make_trainer(clients, dev)
    C, E = len(clients), trainer.E
    n_leaves = len(trainer.params)
    D = sum(p.numel() for p in trainer.params.values())
    log(f"main path: EMNIST CNN, {C} clients, D = {D} params in {n_leaves} "
        f"leaves, E={E}, B={trainer.B}, scheme {trainer.scheme}, "
        f"eta0={trainer.eta0:g}, plan engine, {ROUNDS} rounds")
    ops.reset_launches()
    t0 = time.perf_counter()
    trainer.run(ROUNDS, eval_every=EVAL_EVERY)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(ops.launches)
    for h in trainer.history:
        log(f"  tau={h.tau} loss={h.loss:.6f} acc={h.acc:.4f} eta={h.eta:.3e} "
            f"n_active={h.n_active} event={h.event!r}")
    want = {"weighted_agg": ROUNDS, "masked_sgd": ROUNDS * n_leaves * E}
    log(f"  launches {launches}, expected {want} (weighted_agg 1 per round, "
        f"masked_sgd {n_leaves} leaves x E={E} per round)")
    if launches != want:
        raise RuntimeError(f"launch counts {launches} != expected {want}")
    check_history(trainer.history)

    t0 = time.perf_counter()
    plain = make_trainer(make_clients(), "cpu", agg="flat")
    plain.run(ROUNDS, eval_every=EVAL_EVERY)
    plain_s = time.perf_counter() - t0
    err = compare_with_plain(trainer, plain)
    log(f"  card against the plain path on the CPU ({plain_s:.1f} s): equal "
        f"round records, params max_abs_err {err:.3e} (rtol "
        f"{PARAM_TOL['rtol']:g}, atol {PARAM_TOL['atol']:g}), eval loss "
        f"rtol {LOSS_RTOL:g}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.run(WARM_ROUNDS, eval_every=NO_EVAL)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    log(f"  rounds/s: {ROUNDS / cold_s:.3f} over the first {ROUNDS} rounds "
        f"(eval and first calls included), {WARM_ROUNDS / warm_s:.3f} over "
        f"{WARM_ROUNDS} warm rounds without eval")
    profile_rounds(trainer, PROFILED_ROUNDS)
    return trainer, launches


# -- 5. timing ----------------------------------------------------------------
def device_ms(fn, n: int) -> float:
    """Mean time of fn on the card's timeline, between CUDA events around n
    back-to-back calls.  The card first spins for a few tens of ms, so the
    host queues the calls ahead of it and no call waits for the host as
    far as the queue allows."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound_ms(n_bytes: float, f32_ops: float):
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = f32_ops / F32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else \
        "operations"


def time_weighted_agg(dev, D: int):
    from repro_torch.kernels import weighted_agg as agg
    gen = torch.Generator(device=dev).manual_seed(2)
    K = N_CLIENTS
    c = torch.rand(K, device=dev, generator=gen)
    d = agg.padded(torch.randn(K, D, device=dev, generator=gen))
    kernel = device_ms(lambda: agg.launch(c, d), 100)
    plain = device_ms(lambda: agg.weighted_agg_plain(c, d), 10)
    library = device_ms(lambda: torch.mv(d.t(), c), 100)
    bound, by = bound_ms(4 * (K * D + K + D), 2 * K * D)
    log(f"  weighted_agg, coeffs ({K},) f32 and deltas ({K}, {D}) f32: "
        f"kernel {kernel * 1e3:.1f} us, bound {bound * 1e3:.1f} us by {by}, "
        f"plain {plain * 1e3:.1f} us, torch.mv(deltas.t(), coeffs) "
        f"{library * 1e3:.1f} us")
    return dict(ms=kernel, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=library)


def time_masked_sgd(dev, leaves):
    """One local step: the masked_sgd launch of every leaf, (clients, n)
    f32 with one scale per client."""
    from repro_torch.kernels import masked_sgd as sgd
    gen = torch.Generator(device=dev).manual_seed(3)
    C = N_CLIENTS
    s = 5e-4 * torch.rand(C, device=dev, generator=gen)
    w = [torch.randn(C, n, device=dev, generator=gen) for n in leaves.values()]
    g = [torch.randn(C, n, device=dev, generator=gen) for n in leaves.values()]
    s_col = s[:, None]

    def step(fn):
        def run():
            for wi, gi in zip(w, g):
                fn(wi, gi)
        return run

    kernel = device_ms(step(lambda wi, gi: sgd.launch(wi, gi, s)), 50)
    plain = device_ms(step(lambda wi, gi: sgd.masked_sgd_plain(wi, gi, s)),
                      50)
    library = device_ms(step(lambda wi, gi: wi.addcmul_(s_col, gi,
                                                        value=-1.0)), 50)
    n = C * sum(leaves.values())
    bound, by = bound_ms(4 * (3 * n + len(leaves) * C), 2 * n)
    log(f"  masked_sgd, one local step of {len(leaves)} leaves ({C}, n) f32, "
        f"{n} elements: kernel {kernel * 1e3:.1f} us, bound "
        f"{bound * 1e3:.1f} us by {by}, plain {plain * 1e3:.1f} us, "
        f"w.addcmul_(s, g, value=-1) per leaf {library * 1e3:.1f} us")
    return dict(ms=kernel, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=library)


def main() -> None:
    import_port()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    from repro_torch import resolve_device
    from repro_torch.kernels import build

    card = card_line()
    dev = resolve_device(None)
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device 0: {torch.cuda.get_device_name(0)}")
    log(f"tf32: torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is on")

    t0 = time.perf_counter()
    reports = build.build()
    log(f"build: {len(reports)} of {len(build.SOURCES)} sources compiled in "
        f"{time.perf_counter() - t0:.2f} s into {build.BUILD_DIR}")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    from repro_torch.configs.paper import EMNIST_CNN
    from repro_torch.models.small import init_small
    leaves = {name: p.numel() for name, p in
              sorted(init_small(EMNIST_CNN, device=dev).items())}
    D = sum(leaves.values())
    log("kernels against their plain versions on the card:")
    agg_err = check_weighted_agg(dev, D)
    sgd_err = check_masked_sgd(dev, leaves)

    _, launches = main_path(dev)

    log("timing on the card:")
    agg_t = time_weighted_agg(dev, D)
    sgd_t = time_masked_sgd(dev, leaves)
    csrc = "src/repro_torch/kernels/csrc"
    rows = [
        dict(name="weighted_agg", route="cuda",
             source=f"{csrc}/weighted_agg.cu",
             replaces="src/repro/kernels/weighted_agg.py:108",
             launches=launches["weighted_agg"], max_abs_err=agg_err, **agg_t),
        dict(name="masked_sgd", route="cuda", source=f"{csrc}/masked_sgd.cu",
             replaces="src/repro/kernels/masked_sgd.py:26",
             launches=launches["masked_sgd"], max_abs_err=sgd_err, **sgd_t),
    ]
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
