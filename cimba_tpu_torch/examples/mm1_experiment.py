"""The reference's MM1_multi benchmark as an experiment (torch
restatement of ``examples/mm1_experiment.py``): the model built once and
4096 replications run as the lanes of one batched Sim, their sojourn
times pooled.  ``main`` runs on the card unless the caller asks for the
CPU (``device="cpu"``, with a small ``R`` and ``n_objects``).
"""

from __future__ import annotations

from cimba_tpu_torch.models import mm1
from cimba_tpu_torch.runner import experiment
from cimba_tpu_torch.stats import summary as sm

SEED = 2026


def main(R: int = 4096, n_objects: int = 10_000, device="cuda"):
    spec, _ = mm1.build()
    res = experiment.run_experiment(spec, mm1.params(n_objects=n_objects),
                                    R, seed=SEED, device=device)
    pooled = experiment.pooled_summary(res.sims.user["wait"])
    print(f"replications : {R}  (failed: {int(res.n_failed)})")
    print(f"events       : {int(res.total_events):,}")
    print(f"mean sojourn : {float(sm.mean(pooled)):.4f}   (theory 10.0)")
    print(f"std          : {float(sm.stddev(pooled)):.4f}")
    assert int(res.n_failed) == 0
    assert float(pooled.n) == R * n_objects
    return pooled


if __name__ == "__main__":
    main()
