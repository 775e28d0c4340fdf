"""Serving: the paged cache, the request lifecycle and the plain greedy
scheduler (port of ``repro.serve``).  The engine wrapper, the prefix
cache, chaos and the replica fleet wait for a later slice."""
from repro_torch.serve.lifecycle import (AdmissionError,  # noqa: F401
                                         AdmissionQueue, LifecycleError,
                                         Request, RequestState,
                                         TERMINAL_STATES)
from repro_torch.serve.paged_cache import (InvariantViolation,  # noqa: F401
                                           PagedCache)
from repro_torch.serve.scheduler import Scheduler, sample_tokens  # noqa: F401
