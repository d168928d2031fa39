"""FedState: the federation control plane as plain host data.

Counterpart of ``repro/fed/state.py``: the slot registry,
objective/joined/departed/masked membership, the reboot arrays, the
LR-shift round, the pending event queue, the numpy RNG and the device
draw's key.  Applying an event mutates host bookkeeping only and returns
the *engine actions* (slot admits, evicts and trace writes) it implies;
the StreamScheduler executes them.  ``to_dict``/``from_dict`` round-trip
the whole control plane through plain data, key for key the reference's
(``checkpoint.io`` persists the dict beside the params), which is what
makes a mid-stream checkpoint resume round for round.

Invariants (the reference's):
  * client id == index into ``clients``; founding clients occupy slots
    0..C-1 in id order, later arrivals take the lowest free slot;
  * the queue is a heap keyed by (tau, push order), ``seq`` a plain int
    counter so that it serializes;
  * ``objective_version`` bumps whenever objective membership changes
    (the scheduler's eval-set cache keys on it);
  * ``sample_plan`` consumes the RNG per occupied active slot in slot
    order, the seed loop's draw order, so a seed gives both packages the
    same participation and batch stream;
  * the key (``core.prng``, the reference's jax key words) is a base key,
    never split: round tau's device draw folds tau into it, so the sample
    stream does not depend on how training is cut into run() calls.
"""
from __future__ import annotations

import heapq
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.arrivals import RebootState
from repro_torch.core.departures import BoundTerms, should_exclude
import torch

from repro_torch.core.prng import MASK, prng_key
from repro_torch.fed.driver import Client
from repro_torch.fed.events import (Arrival, Departure, InactivityBurst,
                                    ParticipationEvent, TraceShift,
                                    client_from_dict, client_to_dict,
                                    event_from_dict, event_to_dict)

# engine actions a transition emits: ("admit", slot, client_id),
# ("evict", slot), ("set_trace", slot, trace)
SlotAction = tuple


class FedState:
    """Control-plane state for one federation run."""

    def __init__(self, *, clients: List[Client], capacity: int,
                 reboot_boost: float = 3.0, fast_reboot: bool = True,
                 horizon: Optional[int] = None,
                 bound_terms: Optional[BoundTerms] = None,
                 local_epochs: int = 5, seed: int = 0,
                 rng: Optional[np.random.Generator] = None,
                 key=None,
                 objective: Optional[set] = None,
                 reboots: Optional[List[RebootState]] = None):
        self.clients: List[Client] = clients
        self.capacity = capacity
        self.reboot_boost = reboot_boost
        self.fast_reboot = fast_reboot
        self.horizon = horizon
        self.bound_terms = bound_terms or BoundTerms(
            D=5.0, V=20.0, gamma=10.0, E=local_epochs)
        self.rng = rng if rng is not None else np.random.default_rng(seed)
        self.key = key if key is not None else prng_key(seed)

        C = len(self.clients)
        self.slot_of: Dict[int, int] = {i: i for i in range(C)}
        self.client_at: Dict[int, int] = {i: i for i in range(C)}
        self.free_slots: List[int] = list(range(C, capacity))
        heapq.heapify(self.free_slots)

        self.objective: set = (objective if objective is not None
                               else set(range(C)))
        self.joined: Dict[int, int] = {i: 0 for i in self.objective}
        self.departed: set = set()
        self.mask_until: Dict[int, int] = {}
        self.expiry_taus: set = set()
        self.lr_shift_tau = 0
        self.rb_tau0 = np.zeros(capacity, np.int32)
        self.rb_boost = np.ones(capacity, np.float32)
        self.reboots: List[RebootState] = (reboots if reboots is not None
                                           else [])
        self.objective_version = 0

        self.queue: List[Tuple[int, int, ParticipationEvent]] = []
        self.seq = 0
        self.next_tau = 0
        self.events_applied = 0

    # -- queue ---------------------------------------------------------------
    def push(self, *events: ParticipationEvent) -> None:
        """Enqueue participation events (any order, any time)."""
        for e in events:
            heapq.heappush(self.queue, (e.tau, self.seq, e))
            self.seq += 1

    @property
    def pending(self) -> int:
        return len(self.queue)

    def due(self, tau: int) -> bool:
        return bool(self.queue) and self.queue[0][0] <= tau

    def pop_event(self) -> ParticipationEvent:
        return heapq.heappop(self.queue)[2]

    def compact_stale_traceshifts(self) -> int:
        """Bound the queue under a flood of TraceShifts: among queued stale
        ones (tau already passed, so they all fire at the next boundary)
        keep only the newest per client, which is what applying them in
        order computes, and drop that one too when it restates the
        client's current trace.  Future events and every other kind are
        kept.  Returns the number of events dropped."""
        now = self.next_tau
        keep, newest = [], {}
        for entry in self.queue:
            e = entry[2]
            if isinstance(e, TraceShift) and entry[0] <= now:
                cur = newest.get(e.client_id)
                if cur is None or entry[1] > cur[1]:
                    newest[e.client_id] = entry
            else:
                keep.append(entry)
        for entry in newest.values():
            e = entry[2]
            if not (0 <= e.client_id < len(self.clients)
                    and e.trace == self.clients[e.client_id].trace):
                keep.append(entry)
        dropped = len(self.queue) - len(keep)
        if dropped:
            heapq.heapify(keep)
            self.queue = keep
        return dropped

    # -- membership ----------------------------------------------------------
    def active(self, i: int, tau: int) -> bool:
        return (i in self.objective and i not in self.departed
                and self.joined.get(i, tau + 1) <= tau
                and self.mask_until.get(i, tau) <= tau)

    def register(self, client: Client) -> int:
        self.clients.append(client)
        return len(self.clients) - 1

    def _alloc_slot(self, i: int) -> int:
        if not self.free_slots:
            raise RuntimeError(
                f"engine capacity {self.capacity} exhausted: no free slot "
                f"for arriving client {i} (build the engine with a larger "
                f"capacity=)")
        slot = heapq.heappop(self.free_slots)
        self.slot_of[i] = slot
        self.client_at[slot] = i
        return slot

    def _free_slot(self, i: int, actions: List[SlotAction]) -> None:
        slot = self.slot_of.pop(i, None)
        if slot is None:
            return
        del self.client_at[slot]
        self.rb_tau0[slot] = 0
        self.rb_boost[slot] = 1.0
        heapq.heappush(self.free_slots, slot)
        actions.append(("evict", slot))

    # -- event application ---------------------------------------------------
    def apply(self, e: ParticipationEvent,
              tau: int) -> Tuple[str, List[SlotAction]]:
        """Apply one event at round tau.  Mutates host bookkeeping only;
        returns (event-log string, engine actions)."""
        actions: List[SlotAction] = []
        if isinstance(e, Arrival):
            if e.client is not None:
                i = self.register(e.client)
                actions.append(("admit", self._alloc_slot(i), i))
            else:
                i = e.client_id
                if i is None or not 0 <= i < len(self.clients):
                    raise ValueError(f"Arrival without client needs a "
                                     f"registered client_id, got {i!r}")
                if i not in self.slot_of:
                    actions.append(("admit", self._alloc_slot(i), i))
            if i in self.objective:
                if i not in self.departed:
                    return "", actions          # duplicate arrival: no-op
                # rejoin of an include-departed device: the objective
                # never shifted, so no LR restart / reboot boost
                self.departed.discard(i)
                self.joined[i] = tau
                return f"rejoin:{i};", actions
            self.objective.add(i)
            self.objective_version += 1
            self.joined[i] = tau
            self.departed.discard(i)
            self.lr_shift_tau = tau
            fast = self.fast_reboot if e.fast_reboot is None else \
                e.fast_reboot
            if fast:
                self.reboots.append(RebootState(tau, i, self.reboot_boost))
                slot = self.slot_of[i]
                self.rb_tau0[slot] = tau
                self.rb_boost[slot] = self.reboot_boost
            return f"arrival:{i};", actions

        if isinstance(e, Departure):
            i = e.client_id
            if i not in self.objective or i in self.departed:
                return "", actions              # duplicate/unknown: no-op
            cl = self.clients[i]
            policy = e.policy or cl.departure_policy
            if policy == "auto":
                # Corollary 4.0.3: exclude iff enough training remains
                T = self.horizon if self.horizon is not None else tau + 100
                policy = "exclude" if should_exclude(
                    T, tau, self.bound_terms, cl.gamma_l) else "include"
            self.departed.add(i)
            self._free_slot(i, actions)
            if policy == "exclude":
                self.objective.discard(i)
                self.objective_version += 1
                self.lr_shift_tau = tau
                return f"departure-exclude:{i};", actions
            return f"departure-include:{i};", actions

        if isinstance(e, TraceShift):
            i = e.client_id
            if not 0 <= i < len(self.clients):
                return "", actions              # unknown device: no-op
            # copy-on-shift, not in place: the registered Client may be
            # aliased by the Arrival that delivered it, which must keep
            # its law.  Arrays are shared; plan-mode draws follow the new
            # object
            self.clients[i] = replace(self.clients[i], trace=e.trace)
            slot = self.slot_of.get(i)
            if slot is not None:
                actions.append(("set_trace", slot, e.trace))
            return f"trace-shift:{i};", actions

        if isinstance(e, InactivityBurst):
            until = tau + e.duration
            for i in e.client_ids:
                self.mask_until[i] = max(self.mask_until.get(i, 0), until)
            self.expiry_taus.add(until)
            ids = ",".join(str(i) for i in e.client_ids)
            return f"burst:{ids}@{e.duration};", actions

        raise TypeError(f"unknown participation event {e!r}")

    def upcoming_arrivals(self, until_tau: int):
        """Prefetch planning (read-only), the reference's: the (client_id,
        Client) pairs whose queued Arrivals with tau <= until_tau will
        stage data into a slot when applied — fresh payloads (client_id
        None until registration) and unslotted rejoins.  A currently
        slotted client is included when a Departure for it is also queued
        in the window (evict and rejoin inside one boundary still
        re-admit).  One ``seen`` set holds both ``id(client)`` values and
        client ids, as the reference's does.  The scheduler hands this set
        to the CohortStager (fed/bank.py) so the copy overlaps the current
        span."""
        departing = {e.client_id for t, _, e in self.queue
                     if t <= until_tau and isinstance(e, Departure)}
        out, seen = [], set()
        for t, _, e in self.queue:
            if t > until_tau or not isinstance(e, Arrival):
                continue
            if e.client is not None:
                if id(e.client) not in seen:
                    seen.add(id(e.client))
                    out.append((None, e.client))
            else:
                i = e.client_id
                if (i is not None and 0 <= i < len(self.clients)
                        and i not in seen
                        and (i not in self.slot_of or i in departing)):
                    seen.add(i)
                    out.append((i, self.clients[i]))
        return out

    def expire(self, tau: int) -> bool:
        """Retire a burst expiry landing on tau; True when a masked cohort
        resumed (the span's active mask is stale)."""
        if tau in self.expiry_taus:
            self.expiry_taus.discard(tau)
            return True
        return False

    # -- span arguments (host-side, numpy) ------------------------------------
    def data_weights(self) -> np.ndarray:
        """Slot-indexed data weights p over the current objective.  An
        include-departed client keeps its mass in the normalization but
        holds no slot, so its column never appears."""
        p = np.zeros(self.capacity)
        total = sum(self.clients[i].n for i in self.objective)
        for i in self.objective:
            slot = self.slot_of.get(i)
            if slot is not None:
                p[slot] = self.clients[i].n / total
        return p

    def span_args(self, tau: int) -> dict:
        """The span's per-slot columns at round tau: data weights p, the
        0/1 mask of slots that train (``active``), the LR-shift round and
        the reboot arrays."""
        active = np.zeros(self.capacity, np.float32)
        for slot, i in self.client_at.items():
            if self.active(i, tau):
                active[slot] = 1.0
        return dict(p=self.data_weights().astype(np.float32),
                    active=active,
                    lr_shift_tau=self.lr_shift_tau,
                    reboot_tau0=self.rb_tau0.copy(),
                    reboot_boost=self.rb_boost.copy())

    def span_end(self, tau: int, stop: int, ev: str,
                 eval_every: int) -> int:
        """Largest t <= stop such that [tau, t) has fixed membership and
        at most one eval, which lands on the final round of the span."""
        end = stop
        if self.queue:
            end = min(end, max(self.queue[0][0], tau + 1))
        for t in self.expiry_taus:
            if tau < t < end:
                end = t
        if ev:
            return tau + 1      # event round: evaluate right after it
        next_eval = tau + ((-tau) % eval_every)
        if next_eval < end:
            end = next_eval + 1
        return end

    # -- plan-mode sampling (seed RNG draw order) -----------------------------
    def sample_plan(self, tau: int, E: int, B: int):
        """One round of host-RNG sampling in the seed draw order: alpha
        (capacity, E) and batch indices (capacity, E, B)."""
        alpha = np.zeros((self.capacity, E), np.float32)
        idx = np.zeros((self.capacity, E, B), np.int64)
        for slot in range(self.capacity):
            i = self.client_at.get(slot)
            if i is None or not self.active(i, tau):
                continue
            cl = self.clients[i]
            alpha[slot] = (np.arange(E)
                           < cl.trace.sample_s(self.rng, E)
                           ).astype(np.float32)
            idx[slot] = self.rng.integers(0, cl.n, size=(E, B))
        return alpha, idx

    # -- serialization --------------------------------------------------------
    def to_dict(self) -> dict:
        """Plain-data snapshot (scalars, strings, lists, numpy arrays),
        key for key the reference's: int-keyed maps as sorted item lists,
        the key as the reference's two uint32 words, the RNG as numpy's
        ``bit_generator.state``.  Round-trips exactly through
        ``from_dict``."""
        return {
            "version": 1,
            "capacity": self.capacity,
            "reboot_boost": self.reboot_boost,
            "fast_reboot": self.fast_reboot,
            "horizon": self.horizon,
            "bound_terms": {"D": self.bound_terms.D,
                            "V": self.bound_terms.V,
                            "gamma": self.bound_terms.gamma,
                            "E": self.bound_terms.E},
            "slot_of": sorted(self.slot_of.items()),
            "free_slots": sorted(self.free_slots),
            "objective": sorted(self.objective),
            "joined": sorted(self.joined.items()),
            "departed": sorted(self.departed),
            "mask_until": sorted(self.mask_until.items()),
            "expiry_taus": sorted(self.expiry_taus),
            "lr_shift_tau": self.lr_shift_tau,
            "rb_tau0": self.rb_tau0.copy(),
            "rb_boost": self.rb_boost.copy(),
            "reboots": [[r.tau0, r.client_idx, r.boost]
                        for r in self.reboots],
            "objective_version": self.objective_version,
            "rng_state": self.rng.bit_generator.state,
            "key": key_words(self.key),
            "queue": [[tau, seq, event_to_dict(e)]
                      for tau, seq, e in sorted(self.queue)],
            "seq": self.seq,
            "next_tau": self.next_tau,
            "events_applied": self.events_applied,
            "clients": [client_to_dict(c) for c in self.clients],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FedState":
        """The inverse of ``to_dict``, for a dict made by either package;
        the key comes back as the port's int64 words."""
        if d.get("version") != 1:
            raise ValueError(f"unknown FedState version {d.get('version')!r}")
        bt = d["bound_terms"]
        st = cls(clients=[client_from_dict(c) for c in d["clients"]],
                 capacity=int(d["capacity"]),
                 reboot_boost=float(d["reboot_boost"]),
                 fast_reboot=bool(d["fast_reboot"]),
                 horizon=d["horizon"],
                 bound_terms=BoundTerms(D=bt["D"], V=bt["V"],
                                        gamma=bt["gamma"], E=int(bt["E"])),
                 key=torch.from_numpy(
                     np.asarray(d["key"]).astype(np.int64)))
        st.rng.bit_generator.state = d["rng_state"]
        st.slot_of = {int(i): int(s) for i, s in d["slot_of"]}
        st.client_at = {s: i for i, s in st.slot_of.items()}
        st.free_slots = [int(s) for s in d["free_slots"]]
        heapq.heapify(st.free_slots)
        st.objective = {int(i) for i in d["objective"]}
        st.joined = {int(i): int(t) for i, t in d["joined"]}
        st.departed = {int(i) for i in d["departed"]}
        st.mask_until = {int(i): int(t) for i, t in d["mask_until"]}
        st.expiry_taus = {int(t) for t in d["expiry_taus"]}
        st.lr_shift_tau = int(d["lr_shift_tau"])
        st.rb_tau0 = np.asarray(d["rb_tau0"], np.int32).copy()
        st.rb_boost = np.asarray(d["rb_boost"], np.float32).copy()
        st.reboots = [RebootState(int(t), int(i), float(b))
                      for t, i, b in d["reboots"]]
        st.objective_version = int(d.get("objective_version", 0))
        st.queue = [(int(tau), int(seq), event_from_dict(ev))
                    for tau, seq, ev in d["queue"]]
        heapq.heapify(st.queue)
        st.seq = int(d["seq"])
        st.next_tau = int(d["next_tau"])
        st.events_applied = int(d["events_applied"])
        return st


def key_words(key) -> np.ndarray:
    """A key (``core.prng``: (2,) int64 words) as the reference stores its
    jax key: a (2,) uint32 array."""
    words = np.asarray(torch.as_tensor(key).cpu(), np.int64)
    if words.shape != (2,) or ((words & MASK) != words).any():
        raise ValueError(f"a key is two 32-bit words, got {words!r}")
    return words.astype(np.uint32)
