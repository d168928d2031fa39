"""Typed participation events: the control plane's vocabulary.

Counterpart of ``repro/fed/events.py``:

  * Arrival         a device joins at round tau (a new ``Client``, or a
                    ``client_id`` re-activation);
  * Departure       a device leaves (paper §4.3 include/exclude/auto);
  * TraceShift      a device's availability law changes;
  * InactivityBurst a cohort goes dark for a window (correlated
                    unavailability) but keeps its weight mass.

Every event, and the ``Client`` payload an Arrival may carry, round-trips
through ``event_to_dict``/``event_from_dict``: plain dicts of scalars,
strings and numpy arrays, key for key the reference's, so a dict made by
either package decodes in the other.  ``FedState.to_dict`` embeds them and
``checkpoint.io`` extracts their arrays into the npz
(``checkpoint.io.jsonify_tree``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np

from repro_torch.core.participation import TRACES, Trace
from repro_torch.fed.driver import Client


@dataclass(frozen=True)
class Arrival:
    """A device joins training at round tau.

    Either ``client`` is a brand-new Client (admitted into a free capacity
    slot), or ``client_id`` references an already-registered client
    (activation only — the path the FederatedTrainer adapter uses for
    precomputed schedules).
    """
    tau: int
    client: Optional[Client] = None
    client_id: Optional[int] = None
    fast_reboot: Optional[bool] = None   # None => scheduler default


@dataclass(frozen=True)
class Departure:
    """A device leaves at round tau.  policy: include | exclude | auto
    (Corollary 4.0.3 remaining-time criterion); None uses the client's
    own departure_policy."""
    tau: int
    client_id: int
    policy: Optional[str] = None


@dataclass(frozen=True)
class TraceShift:
    """A client's availability law changes at round tau (e.g. a device
    moves from charger+wifi to battery+cellular)."""
    tau: int
    client_id: int
    trace: Trace


@dataclass(frozen=True)
class InactivityBurst:
    """A cohort goes dark for ``duration`` rounds starting at tau (a
    regional outage, a synchronized OS update).  Masked clients stay in
    the objective, with their weight mass, but contribute s = 0 until the
    burst expires."""
    tau: int
    duration: int
    client_ids: Tuple[int, ...]


ParticipationEvent = Union[Arrival, Departure, TraceShift, InactivityBurst]


# -- codec --------------------------------------------------------------------

_TRACE_BY_NAME = {t.name: t for t in TRACES}


def trace_to_dict(trace: Trace) -> dict:
    return {"name": trace.name, "mean": trace.mean,
            "stdev": trace.stdev, "p_inactive": trace.p_inactive}


def trace_from_dict(d: dict) -> Trace:
    """Interned Table-2 traces come back as the canonical ``TRACES``
    object; custom laws are rebuilt from their moments."""
    t = _TRACE_BY_NAME.get(d["name"])
    if t is not None and (t.mean, t.stdev, t.p_inactive) == \
            (d["mean"], d["stdev"], d["p_inactive"]):
        return t
    return Trace(d["name"], d["mean"], d["stdev"], d["p_inactive"])


def _opt_array(a):
    return None if a is None else np.asarray(a)


def client_to_dict(c: Client) -> dict:
    return {
        "x": np.asarray(c.x),
        "y": _opt_array(c.y),
        "trace": None if c.trace is None else trace_to_dict(c.trace),
        "x_test": _opt_array(c.x_test),
        "y_test": _opt_array(c.y_test),
        "active_from": c.active_from,
        "departs_at": c.departs_at,
        "departure_policy": c.departure_policy,
        "gamma_l": c.gamma_l,
    }


def client_from_dict(d: dict) -> Client:
    return Client(
        x=np.asarray(d["x"]), y=_opt_array(d.get("y")),
        trace=None if d.get("trace") is None
        else trace_from_dict(d["trace"]),
        x_test=_opt_array(d.get("x_test")),
        y_test=_opt_array(d.get("y_test")),
        active_from=int(d.get("active_from", 0)),
        departs_at=d.get("departs_at"),
        departure_policy=d.get("departure_policy", "exclude"),
        gamma_l=float(d.get("gamma_l", 1.0)))


def event_to_dict(e: ParticipationEvent) -> dict:
    if isinstance(e, Arrival):
        return {"kind": "arrival", "tau": e.tau,
                "client": None if e.client is None
                else client_to_dict(e.client),
                "client_id": e.client_id, "fast_reboot": e.fast_reboot}
    if isinstance(e, Departure):
        return {"kind": "departure", "tau": e.tau,
                "client_id": e.client_id, "policy": e.policy}
    if isinstance(e, TraceShift):
        return {"kind": "trace-shift", "tau": e.tau,
                "client_id": e.client_id, "trace": trace_to_dict(e.trace)}
    if isinstance(e, InactivityBurst):
        return {"kind": "burst", "tau": e.tau, "duration": e.duration,
                "client_ids": list(e.client_ids)}
    raise TypeError(f"unknown participation event {e!r}")


def event_from_dict(d: dict) -> ParticipationEvent:
    kind = d["kind"]
    tau = int(d["tau"])
    if kind == "arrival":
        return Arrival(tau,
                       client=None if d.get("client") is None
                       else client_from_dict(d["client"]),
                       client_id=d.get("client_id"),
                       fast_reboot=d.get("fast_reboot"))
    if kind == "departure":
        return Departure(tau, client_id=int(d["client_id"]),
                         policy=d.get("policy"))
    if kind == "trace-shift":
        return TraceShift(tau, client_id=int(d["client_id"]),
                          trace=trace_from_dict(d["trace"]))
    if kind == "burst":
        return InactivityBurst(tau, duration=int(d["duration"]),
                               client_ids=tuple(int(i)
                                                for i in d["client_ids"]))
    raise ValueError(f"unknown event kind {kind!r}")
