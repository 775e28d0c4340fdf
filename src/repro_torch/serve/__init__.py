"""Serving: the paged cache (float or quantized pools), the prefix trie,
the request lifecycle, the scheduler and the engine (dense prefill /
decode steps and the fixed-slot server) — port of ``repro.serve``.
Chaos, the replica fleet (``make_fleet``), speculative decode and sharded
serving wait for later slices."""
from repro_torch.serve.engine import (BatchedServer,  # noqa: F401
                                      ServeConfig, cache_specs,
                                      jit_decode_step, jit_prefill,
                                      serve_param_shardings)
from repro_torch.serve.lifecycle import (AdmissionError,  # noqa: F401
                                         AdmissionQueue, LifecycleError,
                                         Request, RequestState,
                                         TERMINAL_STATES)
from repro_torch.serve.paged_cache import (InvariantViolation,  # noqa: F401
                                           PagedCache)
from repro_torch.serve.prefix_cache import (PrefixCache,  # noqa: F401
                                            PrefixMatch)
from repro_torch.serve.scheduler import Scheduler, sample_tokens  # noqa: F401
