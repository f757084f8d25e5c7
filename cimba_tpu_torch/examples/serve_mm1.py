"""Many clients, one device: the experiment service (torch restatement
of ``examples/serve_mm1.py``).

Four "analyst" threads submit M/M/1 experiment requests at once.  Those
queued together pack into one wave of the class's chunk (seed, parameter
values and R are lane data, so requests differing in them pack), and
each request's lanes are folded back out on their own.  Every result is
bitwise what the same request returns from a direct
``run_experiment_stream`` call, which ``main`` checks.  ``main`` runs on
the card unless the caller asks for the CPU (``device="cpu"``).

Run:  python -m cimba_tpu_torch.examples.serve_mm1 [cpu]
"""

from __future__ import annotations

import threading

from cimba_tpu_torch import serve
from cimba_tpu_torch.models import mm1
from cimba_tpu_torch.obs import audit
from cimba_tpu_torch.runner import experiment
from cimba_tpu_torch.stats import summary as sm

#: (label, n_objects, R, seed)
REQUESTS = (("analyst-a", 200, 32, 1), ("analyst-b", 500, 32, 1),
            ("analyst-c", 200, 32, 7), ("analyst-d", 300, 32, 1))
CHUNK_STEPS = 256
WAVE = 32


def main(device="cuda", requests=REQUESTS, quiet: bool = False) -> dict:
    """Serve ``requests`` from one thread each; returns ``{label:
    StreamResult}`` after checking each against its direct call."""
    spec, _ = mm1.build(record=False)
    cache = serve.ProgramCache()
    # build the wave's programs (on the card, K1's library) before any
    # client arrives, so the first request does not pay for it
    serve.warm(cache, spec, mm1.params(1), WAVE, chunk_steps=CHUNK_STEPS,
               seed=1, device=device)
    out = {}
    with serve.Service(max_wave=2 * WAVE, cache=cache, device=device) as svc:
        def client(label, n, R, seed):
            out[label] = svc.submit(serve.Request(
                spec, mm1.params(n), R, seed=seed, wave_size=WAVE,
                chunk_steps=CHUNK_STEPS, label=label)).result(600)

        threads = [threading.Thread(target=client, args=r) for r in requests]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = svc.stats()
    for label, n, R, seed in requests:
        res = out[label]
        direct = experiment.run_experiment_stream(
            spec, mm1.params(n), R, wave_size=WAVE, chunk_steps=CHUNK_STEPS,
            seed=seed, program_cache=cache, device=device)
        if audit.stream_result_digest(res) != audit.stream_result_digest(
                direct):
            raise AssertionError(f"{label}: served result differs from its "
                                 "direct call")
        if not quiet:
            print(f"{label}: {R} reps x {n} objects (seed {seed})  mean "
                  f"sojourn {float(sm.mean(res.summary)):.4f}  events "
                  f"{int(res.total_events):,}  waves {res.n_waves}  failed "
                  f"{int(res.n_failed)}  (bitwise its direct call)")
    if not quiet:
        ttfw = stats["time_to_first_wave"]
        print(f"service: {stats['batches']} batches (occupancy histogram "
              f"{stats['batch_occupancy']}), {stats['lanes_dispatched']} "
              f"lanes dispatched, queue hwm {stats['queue_depth_hwm']}")
        print("program cache:", stats["program_cache"])
        print(f"time to first wave: mean {ttfw['mean_s'] * 1e3:.1f} ms, max "
              f"{ttfw['max_s'] * 1e3:.1f} ms over {ttfw['count']} requests")
    return out


if __name__ == "__main__":
    import sys

    main(device=sys.argv[1] if len(sys.argv) > 1 else "cuda")
