"""Serving: the paged cache (float or quantized pools), the prefix trie,
the request lifecycle, the scheduler, the engine (dense prefill / decode
steps, the fixed-slot server and ``make_fleet``), the replica fleet, the
chaos harness and speculative decode (the scheduler's ``speculate``) —
port of ``repro.serve``, for every decoder of the arch registry; the
engine's dense steps also serve the whisper encoder-decoder (the paged
scheduler refuses it, as the reference's does).  Sharded serving
(``dist``): the long-context dense step on a mesh (``jit_decode_step``
with ``ServeConfig.long_context``) and the paged steps over a pool
sharded on its page axis (``pool_shard``)."""
from repro_torch.serve.chaos import (ChaosConfig, ChaosReport,  # noqa: F401
                                     FaultPlan, FleetChaosConfig,
                                     FleetChaosReport, FleetFaultPlan,
                                     StepClock, run_fleet_plan, run_plan)
from repro_torch.serve.engine import (BatchedServer,  # noqa: F401
                                      ServeConfig, cache_specs,
                                      jit_decode_step, jit_prefill,
                                      make_fleet, serve_param_shardings)
from repro_torch.serve.fleet import (FleetAuditError,  # noqa: F401
                                     FleetRouter, Replica, ReplicaState)
from repro_torch.serve.lifecycle import (AdmissionError,  # noqa: F401
                                         AdmissionQueue, LifecycleError,
                                         Request, RequestState,
                                         TERMINAL_STATES, retry_with_backoff)
from repro_torch.serve.paged_cache import (InvariantViolation,  # noqa: F401
                                           PagedCache)
from repro_torch.serve.prefix_cache import (PrefixCache,  # noqa: F401
                                            PrefixMatch)
from repro_torch.serve.scheduler import Scheduler, sample_tokens  # noqa: F401
