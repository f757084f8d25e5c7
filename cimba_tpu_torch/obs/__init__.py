"""Observability (torch port of :mod:`cimba_tpu.obs`): the flight
recorder, the metrics registry, exporters, profiling and the
determinism audit.

* :mod:`~cimba_tpu_torch.obs.trace` — the **flight recorder**: each
  lane's ring of its last dispatched events ``(t, pid, kind, arg,
  seq)``, a Sim leaf written at the dispatch site of ``core.loop``;
* :mod:`~cimba_tpu_torch.obs.metrics` — the **metrics registry**:
  dispatches by kind, queue and event-set high-water marks, guard
  retries and the chain-length histogram, as Sim leaves, pooled across
  lanes and waves;
* :mod:`~cimba_tpu_torch.obs.export` and :mod:`~cimba_tpu_torch.obs.prof`
  — Chrome-trace/Perfetto JSON of the rings, and the
  :class:`~cimba_tpu_torch.obs.prof.RunReport` (the build, load and
  execute split, the card's memory statistics, a metrics snapshot);
* :mod:`~cimba_tpu_torch.obs.audit` — chunk-boundary digests, run cards
  and divergence localization.

Host-side: :mod:`~cimba_tpu_torch.obs.telemetry` (the serving control
plane's time series, request-scoped spans and health) and
:mod:`~cimba_tpu_torch.obs.expose` (``/metrics`` Prometheus text,
``/healthz``, ``/varz`` over HTTP).  Every integration point defaults to
``telemetry=None``, and None means no threads, no span objects and
bitwise-unchanged results.

Both the recorder and the registry are switched by module flags read at
``init_sim`` (off: the Sim carries ``None`` and the hooks compute
nothing).  Kernel-path contract (the reference's): a Sim carrying
either, and a generated spec's block reaching an enabled log level,
are refused loudly by a CUDA chunk kernel build; they run on the plain
engine, on the card or the CPU.
"""

from cimba_tpu_torch.obs import metrics, trace  # noqa: F401

# export, prof, audit, telemetry and expose are imported by their callers
# (they pull in json, http and the runner surface; the engine only needs
# trace and metrics)
