"""Typed participation events: the control plane's vocabulary.

Counterpart of ``repro/fed/events.py`` for arrivals and departures; trace
shifts, inactivity bursts and the event codec wait for the streaming
slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

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


ParticipationEvent = Union[Arrival, Departure]
