"""cimba_tpu_torch.serve: the experiment-serving layer (torch port of
:mod:`cimba_tpu.serve`).

Many concurrent experiment requests multiplexed onto one device's built
programs: a single dispatcher thread packs requests of one compatibility
class (requests differing only in params, R, seed, priority, horizon
within a bucket, chunk budget or summary path, each lane carrying its own
seed and horizon) into shared pad-and-masked waves, runs them (on the
card one K1 launch a chunk) and folds each request's lanes back out,
behind admission control, deadlines, cancellation and retries with
backoff.  Every request's result is bitwise its direct
``runner.experiment.run_experiment_stream`` call's.

    from cimba_tpu_torch import serve
    with serve.Service(max_wave=1024) as svc:          # the card
        h = svc.submit(serve.Request(spec, params, 64, seed=1))
        result = h.result(600)       # a runner.experiment.StreamResult

``serve.Service(..., device="cpu")`` runs the plain engine on the CPU.
Submodules: :mod:`~cimba_tpu_torch.serve.cache` (the bounded shared
program cache), :mod:`~cimba_tpu_torch.serve.sched` (queue, deadline and
retry policy), :mod:`~cimba_tpu_torch.serve.service` (the dispatcher,
continuous refill and cross-spec wave fusion),
:mod:`~cimba_tpu_torch.serve.client` (load generators).  Not ported yet: the
persistent program store (``serve/store.py``), the preemptive device
scheduler (``serve/device.py``) and the QoS plane (``qos/``).
"""

from cimba_tpu_torch.serve.cache import ProgramCache, warm
from cimba_tpu_torch.serve.client import (LoadReport, RequestTemplate,
                                          mixed_requests, percentile,
                                          run_load, run_mixed_load)
from cimba_tpu_torch.serve.sched import (AdmissionQueue, Backoff, Cancelled,
                                         DeadlineExceeded,
                                         MemoryBudgetExceeded, QueueFull,
                                         RetriesExhausted, RetryAfter,
                                         ServeError, ServiceClosed)
from cimba_tpu_torch.serve.service import Request, ResultHandle, Service

__all__ = [
    "ProgramCache", "warm",
    "LoadReport", "RequestTemplate", "percentile",
    "run_load", "run_mixed_load", "mixed_requests",
    "AdmissionQueue", "Backoff",
    "ServeError", "QueueFull", "ServiceClosed", "Cancelled",
    "DeadlineExceeded", "RetriesExhausted", "MemoryBudgetExceeded",
    "RetryAfter",
    "Request", "ResultHandle", "Service",
]
