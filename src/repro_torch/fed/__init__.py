"""The federation layer: trainer, scheduler, control plane and engine."""
from repro_torch.core.compression import CompressionSpec, resolve_compression
from repro_torch.fed.driver import Client, FederatedTrainer, RoundRecord
from repro_torch.fed.engine import RoundEngine
from repro_torch.fed.events import (Arrival, Departure, InactivityBurst,
                                    ParticipationEvent, TraceShift)
from repro_torch.fed.faults import (Fault, FaultPlan, InjectedFault,
                                    InjectedWriteError)
from repro_torch.fed.fuzz import (FuzzHarness, InvariantViolation,
                                  generate_case, make_backend_pool,
                                  run_backend_matrix, run_chaos_case,
                                  run_chaos_corpus, run_corpus,
                                  run_cross_backend_case, run_fuzz_case)
from repro_torch.fed.service import FederationService
from repro_torch.fed.sharding import FedSharding, make_fed_sharding
from repro_torch.fed.state import FedState
from repro_torch.fed.stream import StreamScheduler
from repro_torch.fed.task import ArrayTask, BufferSpec, ClientTask, LMTask
from repro_torch.fed.validate import (QuadraticProblem, QuadraticRunner,
                                      RunDump, TheoryValidator,
                                      generate_participation_schedule,
                                      make_quadratic_problem,
                                      validate_corpus)

__all__ = ["CompressionSpec", "resolve_compression", "Client",
           "FederatedTrainer", "RoundRecord", "RoundEngine", "Arrival",
           "Departure", "TraceShift", "InactivityBurst",
           "ParticipationEvent", "FedSharding", "make_fed_sharding",
           "FedState", "StreamScheduler", "ArrayTask", "BufferSpec",
           "ClientTask", "LMTask", "Fault", "FaultPlan", "InjectedFault",
           "InjectedWriteError", "FederationService", "FuzzHarness",
           "InvariantViolation", "generate_case", "run_corpus",
           "run_fuzz_case", "make_backend_pool", "run_backend_matrix",
           "run_cross_backend_case", "run_chaos_case", "run_chaos_corpus",
           "QuadraticProblem", "QuadraticRunner", "RunDump",
           "TheoryValidator", "generate_participation_schedule",
           "make_quadratic_problem", "validate_corpus"]
