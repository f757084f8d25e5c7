"""A million pooled M/M/1 replications in waves (torch restatement of
``examples/large_r_stream.py``).

``run_experiment_stream`` runs ``wave_size`` lanes at a time, folds each
wave's pooled Pébay summary, failure count and event total into the
accumulators and frees the wave before the next one starts, so the card
holds one wave whatever R.  Lane r of wave w is replication
``w * wave_size + r`` with its own (seed, replication) stream, so every
replication runs as it would in one monolithic run.  ``main`` runs on
the card unless the caller asks for the CPU (``device="cpu"``, with a
small ``R``).
"""

from __future__ import annotations

import time

from cimba_tpu_torch.models import mm1
from cimba_tpu_torch.runner import experiment
from cimba_tpu_torch.stats import summary as sm

SEED = 2026
#: a tiny workload a lane: R is the point here, not N
N_OBJECTS = 3


def main(R: int = 2**20, wave: int = 16384, chunk_steps: int = 256,
         device="cuda", quiet: bool = False):
    wave = min(wave, R)
    spec, _ = mm1.build(record=False)
    t0 = time.perf_counter()
    st = experiment.run_experiment_stream(
        spec, mm1.params(n_objects=N_OBJECTS), R, wave_size=wave,
        chunk_steps=chunk_steps, seed=SEED, device=device,
        on_wave=None if quiet else lambda w, lanes: print(
            f"\r  wave {w:4d}  ({lanes:,}/{R:,} lanes)", end="",
            flush=True))
    events = int(st.total_events)
    wall = time.perf_counter() - t0
    if not quiet:
        print()
    print(f"replications : {R:,} in {st.n_waves} waves of {wave:,}"
          f"  (failed: {int(st.n_failed)})")
    print(f"events       : {events:,}  ({events / wall:,.0f} ev/s, "
          f"{wall:.3f} s)")
    print(f"pooled n     : {float(st.summary.n):,.0f} sojourn samples")
    print(f"mean sojourn : {float(sm.mean(st.summary)):.4f}"
          "   (short-run transient; theory's stationary mean is 10.0)")
    print(f"std          : {float(sm.stddev(st.summary)):.4f}")
    assert int(st.n_failed) == 0
    assert float(st.summary.n) == R * N_OBJECTS
    return st, wall


if __name__ == "__main__":
    main()
