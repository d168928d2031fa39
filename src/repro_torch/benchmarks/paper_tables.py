"""Paper-table experiments (one function per table), on the port.

Counterpart of the reference's ``benchmarks/paper_tables.py``: the same
functions, arguments and defaults, through the port's ``FederatedTrainer``
in plan mode, so every table samples participation and batches as the
reference does.

Table 3: scheme accuracy differences vs heterogeneity |T| on SYNTHETIC and
images.  Table 4: fast-reboot recovery epochs vs arrival time tau0.
Table 5: include/exclude crossing epochs vs tau0 and (alpha, beta).

Each table function also takes ``device`` (the CUDA device unless ``"cpu"`` is
asked for), ``init_params`` (the port's parameters of the table's model;
by default the reference's ``init_small(PRNGKey(0), cfg)``, committed in
``reference_init.npz``, see ``benchmarks.reference``) and ``agg`` (the
plan engine's aggregation layout, ``"auto"`` as in the reference).  The
trainers of one row are built by ``table3_trainer``, ``table4_trainer``
and ``table5_trainer``, so a row can be run round by round.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks.reference import reference_init
from repro_torch.configs.paper import MNIST_MLP, SYNTHETIC_LR
from repro_torch.core.participation import TRACES
from repro_torch.data import (iid_partition, label_sorted_partition,
                              make_class_dataset, synthetic_federation)
from repro_torch.fed import Client, FederatedTrainer
from repro_torch.models.small import accuracy_of, logits_small, make_loss_fn


def _eval_fn(cfg):
    """(loss, acc) of one model on held-out (x, y), read back in one
    copy."""
    def f(params, x, y):
        lg = logits_small(params, cfg, x)
        ll = torch.log_softmax(lg, -1)
        loss = -ll.gather(1, y[:, None].long()).mean()
        loss, acc = torch.stack([loss, accuracy_of(lg, y)]).tolist()
        return loss, acc
    return f


def _clients_synthetic(n, alpha, beta, n_traces, seed=0):
    train, test = synthetic_federation(alpha, beta, n, seed=seed)
    rng = np.random.default_rng(seed)
    return [Client(x=tr[0], y=tr[1], trace=TRACES[rng.integers(0, n_traces)],
                   x_test=te[0], y_test=te[1])
            for tr, te in zip(train, test)]


def _clients_images(n, n_traces, noniid, seed=0):
    x, y = make_class_dataset(10, 400, seed=seed)
    if noniid:
        train, test = label_sorted_partition(x, y, n, seed=seed)
    else:
        train, test = iid_partition(x, y, n, seed=seed)
    rng = np.random.default_rng(seed)
    return [Client(x=tr[0], y=tr[1], trace=TRACES[rng.integers(0, n_traces)],
                   x_test=te[0], y_test=te[1])
            for tr, te in zip(train, test)]


def _trainer(cfg, clients, *, init_params, device, agg, seed=0, **kw):
    if init_params is None:
        if seed != 0:
            raise ValueError(f"the reference's initial params are "
                             f"committed for seed 0 only, got seed {seed}: "
                             f"pass init_params=")
        init_params = reference_init(cfg, device)
    return FederatedTrainer(
        loss_fn=make_loss_fn(cfg), eval_fn=_eval_fn(cfg),
        init_params=init_params, clients=clients, local_epochs=5,
        seed=seed, device=device, agg=agg, **kw)


def _table3_setup(dataset, noniid, n_traces, n_clients):
    """(cfg, clients, eta0) of one row of Table 3."""
    if dataset == "synthetic":
        ab = (1.0, 1.0) if noniid else (0.0, 0.0)
        return (SYNTHETIC_LR, _clients_synthetic(n_clients, *ab, n_traces),
                1.0)
    return MNIST_MLP, _clients_images(n_clients, n_traces, noniid), 0.05


def table3_trainer(dataset, noniid, n_traces, scheme, n_clients=24, *,
                   device=None, init_params=None, agg="auto"):
    """The trainer of one cell of Table 3 (one scheme of one row)."""
    cfg, clients, eta0 = _table3_setup(dataset, noniid, n_traces, n_clients)
    return _trainer(cfg, clients, init_params=init_params, device=device,
                    agg=agg, batch_size=cfg.batch_size, scheme=scheme,
                    eta0=eta0)


def _run(cfg, clients, scheme, rounds, eta0, seed=0, *, device=None,
         init_params=None, agg="auto"):
    tr = _trainer(cfg, clients, init_params=init_params, device=device,
                  agg=agg, seed=seed, batch_size=cfg.batch_size,
                  scheme=scheme, eta0=eta0)
    hist = tr.run(rounds, eval_every=5)
    # non-eval rounds record NaN: average the last three evaluated rounds
    accs = [h.acc for h in hist if np.isfinite(h.acc)]
    return float(np.mean(accs[-3:])), tr


def table3_scheme_comparison(rounds=60, n_clients=24, dataset="synthetic",
                             *, device=None, init_params=None, agg="auto"):
    """CSV rows: dataset,iid,|T|,acc_A,acc_B,acc_C,B-A,C-B."""
    rows = []
    for noniid in (False, True):
        for n_traces in (1, 4, 8):
            accs = {}
            for scheme in "ABC":
                cfg, clients, eta0 = _table3_setup(dataset, noniid,
                                                   n_traces, n_clients)
                accs[scheme], _ = _run(cfg, clients, scheme, rounds, eta0,
                                       device=device,
                                       init_params=init_params, agg=agg)
            rows.append((dataset, "niid" if noniid else "iid", n_traces,
                         accs["A"], accs["B"], accs["C"],
                         accs["B"] - accs["A"], accs["C"] - accs["B"]))
    return rows


def table4_trainer(tau0, fast, *, device=None, init_params=None,
                   agg="auto"):
    """The trainer of one run of Table 4: nine founding clients and one
    that arrives at tau0, with or without fast reboot."""
    clients = _clients_synthetic(9, 1.0, 1.0, 5, seed=4)
    extra = _clients_synthetic(1, 1.0, 1.0, 5, seed=99)[0]
    extra.active_from = tau0
    clients.append(extra)
    return _trainer(SYNTHETIC_LR, clients, init_params=init_params,
                    device=device, agg=agg, batch_size=20, scheme="C",
                    eta0=1.0, fast_reboot=fast)


def table4_fast_reboot(rounds_after=60, taus=(10, 30, 50), *, device=None,
                       init_params=None, agg="auto"):
    """Recovery epochs (accuracy back to pre-arrival level) fast vs vanilla
    reboot.  CSV rows: tau0, recover_fast, recover_vanilla."""
    rows = []
    for tau0 in taus:
        rec = {}
        for fast in (True, False):
            tr = table4_trainer(tau0, fast, device=device,
                                init_params=init_params, agg=agg)
            hist = tr.run(tau0 + rounds_after)
            acc_before = hist[tau0 - 1].acc
            rec[fast] = next(
                (h.tau - tau0 for h in hist[tau0 + 1:]
                 if h.acc >= acc_before), rounds_after)
        rows.append((tau0, rec[True], rec[False]))
    return rows


def table5_trainer(a, b, tau0, policy, *, device=None, init_params=None,
                   agg="auto"):
    """The trainer of one run of Table 5: client 0 departs at tau0 under
    ``policy`` (include or exclude)."""
    clients = _clients_synthetic(10, a, b, 5, seed=7)
    clients[0].departs_at = tau0
    clients[0].departure_policy = policy
    return _trainer(SYNTHETIC_LR, clients, init_params=init_params,
                    device=device, agg=agg, batch_size=20, scheme="C",
                    eta0=1.0)


def table5_departure_crossing(taus=(10, 25, 40), abs_=((0.1, 0.1),
                                                       (1.0, 1.0)),
                              *, device=None, init_params=None, agg="auto"):
    """Crossing epochs between include/exclude test-loss curves."""
    rows = []
    for (a, b) in abs_:
        for tau0 in taus:
            losses = {}
            for policy in ("include", "exclude"):
                tr = table5_trainer(a, b, tau0, policy, device=device,
                                    init_params=init_params, agg=agg)
                hist = tr.run(tau0 + 60)
                # evaluate both on the *post-departure* objective of the run
                losses[policy] = np.array([h.loss for h in hist[tau0:]])
            diff = losses["exclude"] - losses["include"]
            cross = next((i for i, d in enumerate(diff) if d <= 0), -1)
            rows.append((a, b, tau0, cross))
    return rows
