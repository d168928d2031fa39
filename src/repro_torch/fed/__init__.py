"""The federation layer: trainer, scheduler, control plane and engine."""
from repro_torch.core.compression import CompressionSpec, resolve_compression
from repro_torch.fed.driver import Client, FederatedTrainer, RoundRecord
from repro_torch.fed.engine import RoundEngine
from repro_torch.fed.events import (Arrival, Departure, InactivityBurst,
                                    ParticipationEvent, TraceShift)
from repro_torch.fed.faults import (Fault, FaultPlan, InjectedFault,
                                    InjectedWriteError)
from repro_torch.fed.service import FederationService
from repro_torch.fed.sharding import FedSharding, make_fed_sharding
from repro_torch.fed.state import FedState
from repro_torch.fed.stream import StreamScheduler
from repro_torch.fed.task import ArrayTask, BufferSpec, ClientTask

__all__ = ["CompressionSpec", "resolve_compression", "Client",
           "FederatedTrainer", "RoundRecord", "RoundEngine", "Arrival",
           "Departure", "TraceShift", "InactivityBurst",
           "ParticipationEvent", "FedSharding", "make_fed_sharding",
           "FedState", "StreamScheduler", "ArrayTask", "BufferSpec",
           "ClientTask", "Fault", "FaultPlan", "InjectedFault",
           "InjectedWriteError", "FederationService"]
