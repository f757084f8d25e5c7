"""The M/G/1 4x5 parameter sweep two ways (torch restatement of
``examples/mg1_sweep.py``):

1. the monolithic experiment array: one batched run, one row of
   parameters a replication (``mg1.sweep_params``);
2. the sweep engine with adaptive-R sequential stopping: each cell runs
   only until its CI halfwidth beats a relative target, spending
   replications where the variance is.

Both are printed beside Pollaczek-Khinchine.  ``main`` runs on the card
unless the caller asks for the CPU (``device="cpu"``, with small sizes
and a smaller grid).

Run:  python -m cimba_tpu_torch.examples.mg1_sweep
"""

from __future__ import annotations

import numpy as np

from cimba_tpu_torch import sweep
from cimba_tpu_torch.models import mg1
from cimba_tpu_torch.runner import experiment as ex

SEED = 7
CVS = (0.25, 0.5, 1.0, 2.0)
UTILIZATIONS = (0.5, 0.6, 0.7, 0.8, 0.9)


def main(n_objects: int = 20_000, reps_per_cell: int = 10,
         adaptive_objects: int = 2_000, adaptive_reps: int = 8,
         target: float = 0.01, max_rounds: int = 24,
         chunk_steps: int = 2048, cvs=CVS, utilizations=UTILIZATIONS,
         device="cuda"):
    spec, _ = mg1.build()

    # --- 1. the monolithic experiment array (fixed R everywhere) ---
    params, cells = mg1.sweep_params(n_objects, cvs=cvs,
                                     utilizations=utilizations,
                                     reps_per_cell=reps_per_cell)
    res = ex.run_experiment(spec, params, len(cells), seed=SEED,
                            device=device)
    means = res.sims.user["wait"].m1.detach().cpu().double().numpy()
    print(f"monolithic: {len(cells)} replications, failed: "
          f"{int(res.n_failed)}")
    print(" cv    rho   simulated  theory")
    mono = {}
    for cv, rho in dict.fromkeys(cells):
        idx = [k for k, c in enumerate(cells) if c == (cv, rho)]
        mono[cv, rho] = float(means[idx].mean())
        print(f"{cv:4.2f}  {rho:4.2f}  {mono[cv, rho]:9.3f}  "
              f"{mg1.pk_sojourn(rho, cv):7.3f}")

    # --- 2. the adaptive engine: every cell to +-target --------------
    grid = mg1.sweep_grid(adaptive_objects, cvs=cvs,
                          utilizations=utilizations)
    adaptive = sweep.run_sweep(
        spec, grid, reps_per_cell=adaptive_reps,
        stop=sweep.HalfwidthTarget(target=target, relative=True),
        max_rounds=max_rounds, seed=SEED, cell_wave=adaptive_reps,
        chunk_steps=chunk_steps, device=device)
    print(f"\nadaptive: {int(adaptive.n_reps.sum())} replications across "
          f"{grid.n_cells} cells, {adaptive.n_rounds} rounds (fixed-R "
          f"sized for the worst cell would be "
          f"{int(adaptive.n_reps.max()) * grid.n_cells})")
    print(" cv    rho   mean      +/-hw     reps  theory")
    for row in adaptive.rows():
        print(f"{row['cv']:4.2f}  {row['rho']:4.2f}  {row['mean']:8.3f}"
              f"  {row['halfwidth']:8.3f}  {row['reps']:4d}"
              f"  {mg1.pk_sojourn(row['rho'], row['cv']):7.3f}")
    assert int(res.n_failed) == 0 and int(adaptive.n_failed.sum()) == 0
    assert np.isfinite(adaptive.halfwidth).all()
    return mono, adaptive


if __name__ == "__main__":
    main()
