"""Device-resident multi-round federated engine, plan mode.

Counterpart of ``repro/fed/engine.py``.  Client datasets are padded to a
common length and live on the device once, as (capacity, Nmax, ...)
stacks; a round gathers its batches there from host-sampled indices (the
*plan*: alpha masks and batch indices drawn with the numpy RNG in the
seed order, so the run is sample-for-sample the reference's).  Scheme
A/B/C coefficients, the fast-reboot boost (exact O((tau-tau0)^-2) decay at
every round) and the staircase LR are computed on the device, and the
round's deltas are reduced with one kernel launch (``agg="flat"``) or leaf
by leaf (``agg="tree"``), through the wire format of ``compression=``.
``mode="client_sequential"`` trains the clients one at a time into a
streaming accumulator instead (``core.fed_step.fed_round_sequential``).

Capacity slots: slots beyond the founding clients start empty;
``admit_many`` writes a burst of clients into slots with one transfer per
buffer, so a membership event never rebuilds the engine.  Device-mode
sampling (the on-device inverse-CDF draw of the trace law) waits for a
later slice; this engine takes a plan.

Sharding: with ``sharding=FedSharding(...)`` (``fed/sharding.py``) the
capacity is padded to whole slots per rank and this rank's buffers hold
only its own slots.  Every rank takes the same full plan; ``s`` and the
scheme coefficients (boost included) are computed over the whole
capacity, and only then is the rank's share of alpha, the batch indices
and the coefficients cut (``FedSharding.shard``).  Each rank trains its
own clients and the aggregation ends in one all-reduce, so the params stay
replicated and the metrics are the whole federation's on every rank.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.aggregation import scheme_coefficients
from repro_torch.core.compression import resolve_compression
from repro_torch.core.fed_step import (fed_round_parallel,
                                       fed_round_sequential)
from repro_torch.device import resolve_device
from repro_torch.fed.task import ArrayTask

Params = Dict[str, torch.Tensor]


class RoundEngine:
    """Runs spans of federated rounds on device-resident client data.

    The model layer is a ClientTask (fed/task.py); ``loss_fn=`` wraps into
    the equivalent ArrayTask.  Membership, data weights p, the LR-restart
    round and reboot state are constant within a span (the scheduler
    splits spans at every event) and enter ``run_span`` as arguments.

    ``agg="auto"`` picks ``"flat"``, the kernel path, on CUDA, and
    ``"tree"`` on the CPU, where the kernel's plain version loops over the
    clients and the per-leaf reduction is cheaper; on a quantized wire
    (``compression="int8"`` or ``"int8-topk"``) it picks ``"flat"`` on the
    CPU too, as the reference does: the plain version reduces the int8
    payload as it is.  ``model_kind`` (``PaperModelConfig.kind``) fixes
    the quantized wire's element order: the CNN's is gathered into the
    reference's (``core.aggregation.flatten_for_wire``).

    ``mode`` is ``"client_parallel"`` (all clients as one batch, then one
    reduction of their (C, D) deltas) or ``"client_sequential"`` (one
    client at a time into an f32 accumulator, memory-bounded; ``agg`` does
    not apply to it).
    """

    def __init__(self, *, clients, local_epochs: int, batch_size: int,
                 loss_fn=None, task=None, scheme: str = "C",
                 eta0: float = 0.01, agg: str = "auto",
                 capacity: Optional[int] = None,
                 max_samples: Optional[int] = None, device=None,
                 compression=None, model_kind: Optional[str] = None,
                 sharding=None, mode: str = "client_parallel"):
        if mode not in ("client_parallel", "client_sequential"):
            raise ValueError(f"mode must be client_parallel|"
                             f"client_sequential, got {mode!r}")
        if mode == "client_sequential" and sharding is not None:
            raise ValueError("the client-sequential round is not sharded "
                             "yet (ROADMAP item 6): pass sharding= with "
                             "mode='client_parallel'")
        self.mode = mode
        if (task is None) == (loss_fn is None):
            raise ValueError("pass exactly one of task= or loss_fn=")
        if task is None:
            if not clients:
                raise ValueError("RoundEngine needs at least one founding "
                                 "client (fixes the feature shape)")
            task = ArrayTask(loss_fn, np.asarray(clients[0].x).shape[1:])
        self.task = task
        self.loss_fn = task.loss_fn
        self.device = resolve_device(device)
        self.E = local_epochs
        self.B = batch_size
        self.scheme = scheme
        self.eta0 = eta0
        # a tensor, so eta0 / x is a true f32 division (a Python number
        # over a tensor is computed as eta0 * (1 / x), rounded twice)
        self._eta0 = torch.tensor(eta0, dtype=torch.float32,
                                  device=self.device)
        # the delta wire format (core/compression)
        self.compression = resolve_compression(compression)
        self.model_kind = model_kind
        if agg == "auto":
            agg = ("flat" if self.device.type == "cuda"
                   or self.compression.quantized else "tree")
        if agg not in ("tree", "flat"):
            raise ValueError(f"agg must be auto|tree|flat, got {agg!r}")
        self.agg = agg

        C = len(clients)
        if C == 0 and (capacity is None or max_samples is None):
            raise ValueError("RoundEngine without founding clients needs "
                             "explicit capacity= and max_samples=")
        if capacity is None:
            capacity = C
        if capacity < max(C, 1):
            raise ValueError(f"capacity {capacity} < {C} founding clients")
        self.sharding = sharding
        if sharding is not None:
            # every rank owns the same number of whole slots; the extra
            # ones are ordinary empty capacity slots (p = 0, never train)
            capacity = sharding.pad_capacity(capacity)
            self.local_slots = sharding.slots(capacity)
        else:
            self.local_slots = range(capacity)
        self.capacity = capacity
        nmax = max((c.n for c in clients), default=1)
        if max_samples is not None:
            nmax = max(nmax, max_samples)
        self.nmax = nmax
        lo, n_local = self.local_slots.start, len(self.local_slots)
        stacks = {name: np.zeros((n_local, nmax) + spec.shape, spec.dtype)
                  for name, spec in task.buffers.items()}
        for i, c in enumerate(clients):
            if i in self.local_slots:
                for name, arr in self._client_rows(c).items():
                    stacks[name][i - lo, :c.n] = arr
        # datasets move host->device exactly once, here; under sharding
        # each rank holds only the rows of the slots it owns
        self.data = {name: torch.from_numpy(buf).to(self.device)
                     for name, buf in stacks.items()}
        self._slots = torch.arange(n_local, device=self.device)[:, None,
                                                                None]

    def _client_rows(self, client):
        """The task's per-sample arrays for one client, shape-checked
        against the engine's buffer specs."""
        arrays = self.task.client_arrays(client)
        for name, arr in arrays.items():
            spec = self.task.buffers[name]
            if arr.shape != (client.n,) + spec.shape:
                raise ValueError(
                    f"feature shape {arr.shape[1:]} != engine feature "
                    f"shape {spec.shape} (buffer {name!r})")
        return arrays

    def _check_slot(self, slot: int) -> None:
        if not 0 <= slot < self.capacity:
            raise IndexError(f"slot {slot} out of range [0, {self.capacity})")

    # -- capacity-slot lifecycle ----------------------------------------------
    def admit_many(self, assignments) -> None:
        """Write a burst of (slot, client) pairs into their slots: the rows
        are padded and stacked on the host, then go up as one transfer and
        one indexed write per buffer.  Under sharding every rank checks the
        whole burst and writes only the slots it owns, at their local
        rows."""
        assignments = list(assignments)
        if not assignments:
            return
        slots = [slot for slot, _ in assignments]
        for slot in slots:
            self._check_slot(slot)
        if len(set(slots)) != len(slots):
            raise ValueError(f"admit_many got duplicate slots: {slots}")
        for _, c in assignments:
            if c.n > self.nmax:
                raise ValueError(
                    f"client has {c.n} samples > slot capacity {self.nmax}; "
                    f"build the engine with max_samples >= {c.n}")
        assignments = [(slot - self.local_slots.start, c)
                       for slot, c in assignments if slot in self.local_slots]
        if not assignments:
            return
        index = torch.tensor([row for row, _ in assignments],
                             device=self.device)
        for name, spec in self.task.buffers.items():
            rows = np.zeros((len(assignments), self.nmax) + spec.shape,
                            spec.dtype)
            for j, (_, c) in enumerate(assignments):
                rows[j, :c.n] = self._client_rows(c)[name]
            self.data[name][index] = torch.from_numpy(rows).to(self.device)

    def evict(self, slot: int) -> None:
        """Free a slot.  Its data stays on the device, unreachable (alpha =
        0 and coefficient 0: the plan and the weights skip a free slot)
        until the next admit overwrites it."""
        self._check_slot(slot)

    # -- one round ------------------------------------------------------------
    def _round_core(self, params, alpha, idx, tau, p, rb_tau0, rb_boost,
                    lr_shift: int):
        s = alpha.sum(-1)
        coeffs = scheme_coefficients(self.scheme, p, s, self.E)
        # fast-reboot boost, exact O((tau-tau0)^-2) decay at every tau;
        # rb_boost == 1 for never-rebooted clients => multiplier 1
        dt = torch.clamp(tau - rb_tau0, min=0).float()
        coeffs = coeffs * (1.0 + (rb_boost - 1.0) / (1.0 + dt).square())
        eta = self._eta0 / torch.clamp((tau + 1 - lr_shift).float(), min=1.0)
        if self.sharding is not None:
            # s and the coefficients are the whole capacity's (scheme A
            # normalises over every slot); only now is this rank's share
            # cut (idx came up already cut: run_span)
            alpha, coeffs = (self.sharding.shard(x) for x in (alpha, coeffs))
        batches = self.task.make_batch(
            {name: buf[self._slots, idx] for name, buf in self.data.items()})
        if self.mode == "client_sequential":
            params = fed_round_sequential(self.loss_fn, params, batches,
                                          alpha, coeffs, eta,
                                          compression=self.compression,
                                          model_kind=self.model_kind)
        else:
            params = fed_round_parallel(self.loss_fn, params, batches, alpha,
                                        coeffs, eta, agg=self.agg,
                                        compression=self.compression,
                                        model_kind=self.model_kind,
                                        sharding=self.sharding)
        return params, s, eta

    # -- host entry point -----------------------------------------------------
    def run_span(self, params: Params, tau_start: int, n_rounds: int, *,
                 plan, p, lr_shift_tau: int, reboot_tau0, reboot_boost):
        """Run n_rounds starting at tau_start with fixed membership.

        plan: (alphas (R, capacity, E), idxs (R, capacity, E, B)) sampled on
        the host.  Under sharding only this rank's slots of idxs go up;
        alphas go up whole, for s over the whole capacity.  params are
        updated in place.  Returns (params, metrics)
        with the metrics still on the device, stacked over rounds:
        s (R, capacity) and eta (R,), so the host does not wait for the
        span; the caller reads them back when it needs them.
        """
        dev = self.device
        p = torch.as_tensor(p, dtype=torch.float32, device=dev)
        rb_tau0 = torch.as_tensor(reboot_tau0, dtype=torch.int32, device=dev)
        rb_boost = torch.as_tensor(reboot_boost, dtype=torch.float32,
                                   device=dev)
        alphas = torch.as_tensor(plan[0], dtype=torch.float32, device=dev)
        idxs = np.asarray(plan[1])
        if self.sharding is not None:
            idxs = self.sharding.shard(idxs.swapaxes(0, 1)).swapaxes(0, 1)
        idxs = torch.as_tensor(idxs, dtype=torch.int64, device=dev)
        # round indices are made on the device: a host scalar per round
        # would be a blocking copy per round
        taus = tau_start + torch.arange(n_rounds, dtype=torch.int32,
                                        device=dev)
        ss, etas = [], []
        for r in range(n_rounds):
            params, s, eta = self._round_core(
                params, alphas[r], idxs[r], taus[r], p, rb_tau0, rb_boost,
                lr_shift_tau)
            ss.append(s)
            etas.append(eta)
        if not ss:
            return params, {"s": torch.zeros((0, self.capacity), device=dev),
                            "eta": torch.zeros(0, device=dev)}
        return params, {"s": torch.stack(ss), "eta": torch.stack(etas)}
