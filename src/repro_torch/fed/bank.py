"""Tiered client store + double-buffered cohort prefetch.

Counterpart of ``repro/fed/bank.py``.  The RoundEngine's capacity slots
hold client data on the device, which caps the fleet at device memory and
makes every arrival a synchronous host->device copy at a span boundary.
This module makes the slots a managed hot cache over a host-side tier:

  * ClientBank — the fleet's home: every client's per-sample buffers live
    host-side as pre-padded ``(Nmax, *spec.shape)`` numpy rows keyed by
    client id, optionally spilling least-recently-used entries to
    per-client ``client-<id>.npz`` files under ``spill_dir`` when a
    ``ram_budget_bytes`` is set (the reference's file names and keys, so
    either package reads the other's spill files).  Registration is
    idempotent and the store is lock-protected, so the staging thread and
    the scheduler's event loop can touch it concurrently.

  * CohortStager — the double buffer: while span k runs, the coalesced
    Arrival/rejoin cohort of the next event boundaries is gathered from
    the bank on a staging thread, stacked into one pow2-padded buffer per
    task buffer and moved to the device (``RoundEngine.put_burst``).  At
    the boundary the scheduler pays only a gather and scatter
    (``RoundEngine.commit_burst``).

On a CUDA device the stager stages on its own ``torch.cuda.Stream``,
created once per stager: its worker thread enters
``torch.cuda.device(engine.device)`` (a new thread's current device is
device 0), builds each stack in pinned host memory, queues the copies on
that stream with ``non_blocking=True``, records an event after them and
waits on it before it marks the cohort done — the reference's
``jax.block_until_ready`` on its staging thread.  The worker takes its
next cohort only after that wait, so no pinned stack is rewritten while
its copy runs.  ``commit_burst`` marks the staged tensors as used by the
scheduler's stream (``record_stream``), so dropping a retained cohort
never lets the allocator hand its blocks back to the staging stream while
the scatter may still read them.  On the CPU (the device asked for) there
is no stream and no pinned memory: the stacks are numpy arrays, as on the
admit path.

Staged cohorts carry data rows only: a slot's ``n`` and s-law row are
written at commit from the live Client object, so a TraceShift landing
between staging and commit can never publish a stale availability law.
Cohort rows are keyed by ``id(client)``: the stager pins the staged
Client objects, and FedState registers arrival payloads by reference, so
the key is stable from prefetch to admit.

The bytes that reach a slot are the same pre-padded rows the synchronous
path would stage, only earlier: bank-backed runs are bit-identical to
device-resident runs of the same schedule (tests/test_torch_bank.py).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def pad_rows(task, nmax: int, client) -> Dict[str, np.ndarray]:
    """Zero-padded (Nmax, *spec.shape) host rows for every task buffer —
    the exact bytes RoundEngine stages into a slot (shape-checked against
    the task's buffer specs)."""
    if client.n > nmax:
        raise ValueError(
            f"client has {client.n} samples > bank row capacity {nmax}; "
            f"build the engine/bank with max_samples >= {client.n}")
    rows = {}
    for name, arr in task.client_arrays(client).items():
        spec = task.buffers[name]
        if arr.shape != (client.n,) + spec.shape:
            raise ValueError(
                f"feature shape {arr.shape[1:]} != bank feature shape "
                f"{spec.shape} (buffer {name!r})")
        row = np.zeros((nmax,) + spec.shape, spec.dtype)
        row[:client.n] = arr
        rows[name] = row
    return rows


class ClientBank:
    """Host-RAM (optionally disk-spillable) store of pre-padded client
    rows, keyed by client id.

    Every row dict has the same geometry (the engine's buffer specs padded
    to Nmax), so memory accounting is exact: ``row_nbytes`` per resident
    client.  With ``ram_budget_bytes`` set (requires ``spill_dir``),
    least-recently-used entries spill to per-client ``client-<id>.npz``
    files and reload on access.
    """

    def __init__(self, task, nmax: int, *,
                 spill_dir: Optional[str] = None,
                 ram_budget_bytes: Optional[int] = None):
        self.task = task
        self.nmax = nmax
        self.spill_dir = spill_dir
        if ram_budget_bytes is not None and spill_dir is None:
            raise ValueError("ram_budget_bytes needs spill_dir= to have "
                             "somewhere to evict to")
        self.ram_budget_bytes = ram_budget_bytes
        self.row_nbytes = sum(
            int(np.prod((nmax,) + spec.shape)) * np.dtype(spec.dtype).itemsize
            for spec in task.buffers.values())
        self._resident: "OrderedDict[int, Dict[str, np.ndarray]]" = \
            OrderedDict()
        self._spilled: Dict[int, str] = {}
        self._lock = threading.RLock()
        self.puts = 0
        self.loads = 0
        self.spills = 0

    def __contains__(self, cid: int) -> bool:
        with self._lock:
            return cid in self._resident or cid in self._spilled

    def __len__(self) -> int:
        with self._lock:
            return len(self._resident) + len(self._spilled)

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return len(self._resident) * self.row_nbytes

    def put(self, cid: int, client,
            rows: Optional[Dict[str, np.ndarray]] = None) -> bool:
        """Register a client's rows (idempotent: an id already banked is a
        cheap no-op).  ``rows=`` accepts pre-padded rows (a staged
        cohort's host rows) to skip re-padding."""
        with self._lock:
            if cid in self._resident:
                self._resident.move_to_end(cid)
                return False
            if cid in self._spilled:
                return False
            if rows is None:
                rows = pad_rows(self.task, self.nmax, client)
            self._resident[cid] = rows
            self.puts += 1
            self._enforce_budget(keep=cid)
            return True

    def rows(self, cid: int) -> Dict[str, np.ndarray]:
        """The client's pre-padded rows, reloaded from spill if needed
        (marks the entry most recently used)."""
        with self._lock:
            if cid in self._resident:
                self._resident.move_to_end(cid)
                return self._resident[cid]
            path = self._spilled.get(cid)
            if path is None:
                raise KeyError(f"client {cid} not in bank")
            with np.load(path) as z:
                rows = {name: z[name] for name in z.files}
            del self._spilled[cid]
            self._resident[cid] = rows
            self.loads += 1
            self._enforce_budget(keep=cid)
            return rows

    def drop(self, cid: int) -> None:
        with self._lock:
            self._resident.pop(cid, None)
            path = self._spilled.pop(cid, None)
        if path is not None:
            try:
                os.unlink(path)
            except OSError:
                pass

    def _enforce_budget(self, keep: Optional[int] = None) -> None:
        # the caller holds the lock
        if self.ram_budget_bytes is None:
            return
        while (len(self._resident) * self.row_nbytes > self.ram_budget_bytes
               and len(self._resident) > 1):
            cid = next(iter(self._resident))
            if cid == keep:
                # the entry being protected is LRU-first (a fresh put into
                # an over-budget bank): spill the next-oldest instead
                cids = iter(self._resident)
                next(cids)
                try:
                    cid = next(cids)
                except StopIteration:
                    return
            self._spill_one(cid)

    def _spill_one(self, cid: int) -> None:
        rows = self._resident.pop(cid)
        os.makedirs(self.spill_dir, exist_ok=True)
        path = os.path.join(self.spill_dir, f"client-{cid:08d}.npz")
        np.savez(path, **rows)
        self._spilled[cid] = path
        self.spills += 1

    def stats(self) -> dict:
        with self._lock:
            return {"clients": len(self._resident) + len(self._spilled),
                    "resident": len(self._resident),
                    "spilled": len(self._spilled),
                    "resident_bytes": len(self._resident) * self.row_nbytes,
                    "row_nbytes": self.row_nbytes,
                    "puts": self.puts, "loads": self.loads,
                    "spills": self.spills}


@dataclass
class StagedCohort:
    """One prefetched arrival cohort: pow2-padded device stacks plus the
    row of each staged client (keyed by ``id(client)``; the ``clients``
    list pins those ids for the cohort's lifetime).  ``rows`` keeps the
    per-client host rows so the boundary can bank a fresh arrival without
    re-padding it on the span loop's thread."""
    clients: List
    index: Dict[int, int]
    dev: Dict[str, torch.Tensor]
    rows: List[Dict[str, np.ndarray]]
    k: int
    stage_seconds: float


class CohortStager:
    """Stages upcoming arrival cohorts on a background worker thread.

    ``submit()`` hands the cohort to a persistent daemon worker that
    gathers rows (from the bank when the client is registered, padding
    fresh payloads otherwise), stacks them pow2-padded, and moves them to
    the device with RoundEngine.put_burst — on CUDA on the stager's own
    stream from pinned memory (module docstring) — while the current span
    computes.  ``collect()`` waits for the staging to finish (recording
    how long the boundary actually waited) and hands the cohort to the
    scheduler exactly once.  A new submit supersedes an uncollected one.
    Staging errors are kept in ``stage_errors`` and surface as an ordinary
    prefetch miss, as the reference's are: the synchronous admit path
    stays the fallback for correctness.

    The worker exits after ``IDLE_TIMEOUT_S`` without work and is
    respawned on the next submit, so schedulers built in bulk and
    abandoned without ``close()`` don't accumulate parked threads, while a
    hot span loop never pays a thread spawn at a boundary.
    """

    IDLE_TIMEOUT_S = 5.0

    def __init__(self, engine, bank: Optional[ClientBank] = None):
        self._engine = engine
        self._bank = bank
        # the staging stream: one per stager, on the engine's card
        self._stream = (torch.cuda.Stream(device=engine.device)
                        if engine.device.type == "cuda" else None)
        self._cv = threading.Condition()
        self._work: Optional[Tuple[list, dict]] = None   # (items, box)
        self._pending: Optional[dict] = None             # box
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        self.cohorts_staged = 0
        self.rows_staged = 0
        self.stage_seconds_total = 0.0
        self.wait_seconds_total = 0.0
        self.superseded = 0
        self.stage_errors = 0

    def submit(self, items: Sequence[Tuple[Optional[int], object]]) -> None:
        """items: (client_id or None, Client) pairs — ids register into
        the bank on the staging thread; fresh payloads (unregistered
        arrivals) are padded directly."""
        items = list(items)
        if not items:
            return
        box: dict = {"cohort": None, "err": None,
                     "done": threading.Event()}
        with self._cv:
            if self._pending is not None:
                # superseded: the event set for the boundary changed
                self._pending = None
                self.superseded += 1
            self._work = (items, box)
            self._pending = box
            self._closed = False
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._worker_loop, name="fed-cohort-stager",
                    daemon=True)
                self._worker.start()
            self._cv.notify_all()

    def _worker_loop(self) -> None:
        # a new thread's current device is device 0: stage on the engine's
        with (torch.cuda.device(self._engine.device)
              if self._stream is not None else contextlib.nullcontext()):
            while True:
                with self._cv:
                    deadline = time.monotonic() + self.IDLE_TIMEOUT_S
                    while self._work is None and not self._closed:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0.0 or not self._cv.wait(remaining):
                            if self._work is None:
                                return        # idle timeout: park
                    if self._work is None:    # closed with nothing queued
                        return
                    work, self._work = self._work, None
                self._stage(*work)

    def _stage(self, items, box) -> None:
        try:
            t0 = time.perf_counter()
            clients, rows_list = [], []
            for cid, c in items:
                if self._bank is not None and cid is not None:
                    self._bank.put(cid, c)
                    rows_list.append(self._bank.rows(cid))
                else:
                    rows_list.append(pad_rows(self._engine.task,
                                              self._engine.nmax, c))
                clients.append(c)
            k = len(clients)
            dev = self._put(rows_list, _pow2(k))
            box["cohort"] = StagedCohort(
                clients=clients,
                index={id(c): j for j, c in enumerate(clients)},
                dev=dev, rows=rows_list, k=k,
                stage_seconds=time.perf_counter() - t0)
        except Exception as e:
            box["err"] = e
        finally:
            box["done"].set()

    def _put(self, rows_list, kp: int) -> Dict[str, torch.Tensor]:
        """The cohort's rows stacked pow2-padded (the last row repeated)
        and on the device, the copies finished when this returns."""
        eng = self._engine
        pad = [rows_list[-1]] * (kp - len(rows_list))
        if self._stream is None:
            return eng.put_burst({
                name: np.stack([r[name] for r in rows_list + pad])
                for name in eng.task.buffers})
        stacks = {}
        for name in eng.task.buffers:
            first = rows_list[0][name]
            dtype = torch.from_numpy(np.empty(0, first.dtype)).dtype
            host = torch.empty((kp,) + first.shape, dtype=dtype,
                               pin_memory=True)
            np.stack([r[name] for r in rows_list + pad], out=host.numpy())
            stacks[name] = host
        dev = eng.put_burst(stacks, stream=self._stream)
        # wait for the copies here, on the staging thread: the boundary's
        # collect() must find them done, and the pinned stacks may go
        copied = torch.cuda.Event()
        copied.record(self._stream)
        copied.synchronize()
        return dev

    def collect(self) -> Optional[StagedCohort]:
        """The staged cohort for this boundary, or None (nothing submitted
        or staging failed).  Consumes the cohort."""
        with self._cv:
            box, self._pending = self._pending, None
        if box is None:
            return None
        t0 = time.perf_counter()
        box["done"].wait()
        self.wait_seconds_total += time.perf_counter() - t0
        if box["err"] is not None:
            self.stage_errors += 1
            return None
        cohort = box["cohort"]
        self.cohorts_staged += 1
        self.rows_staged += cohort.k
        self.stage_seconds_total += cohort.stage_seconds
        return cohort

    def close(self) -> None:
        """Drop any in-flight staging work and retire the worker (so no
        stray copy outlives the scheduler).  Idempotent; a later submit()
        respawns the worker."""
        with self._cv:
            box, self._pending = self._pending, None
            work, self._work = self._work, None
            self._closed = True
            worker, self._worker = self._worker, None
            self._cv.notify_all()
        if work is not None:
            work[1]["done"].set()         # never picked up: unblock waiters
        if box is not None:
            box["done"].wait()
        if worker is not None and worker.is_alive():
            worker.join(timeout=self.IDLE_TIMEOUT_S + 1.0)

    def overlap_fraction(self) -> float:
        """Fraction of staging wall time hidden behind span compute:
        1 - wait/stage (1.0 = boundaries never waited)."""
        if self.stage_seconds_total <= 0.0:
            return 0.0
        return max(0.0, 1.0 - self.wait_seconds_total
                   / self.stage_seconds_total)

    def stats(self) -> dict:
        return {"cohorts_staged": self.cohorts_staged,
                "rows_staged": self.rows_staged,
                "stage_seconds_total": self.stage_seconds_total,
                "wait_seconds_total": self.wait_seconds_total,
                "overlap_fraction": self.overlap_fraction(),
                "superseded": self.superseded,
                "stage_errors": self.stage_errors}


def _pow2(k: int) -> int:
    return 1 << (k - 1).bit_length() if k > 1 else 1
