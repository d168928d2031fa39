"""Typed participation events: the control plane's vocabulary.

Counterpart of ``repro/fed/events.py``:

  * Arrival         a device joins at round tau (a new ``Client``, or a
                    ``client_id`` re-activation);
  * Departure       a device leaves (paper §4.3 include/exclude/auto);
  * TraceShift      a device's availability law changes;
  * InactivityBurst a cohort goes dark for a window (correlated
                    unavailability) but keeps its weight mass.

The event codec (``event_to_dict``/``event_from_dict``) waits for the
checkpoint slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

from repro_torch.core.participation import Trace
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
