"""Tutorial 5, agent-based AWACS (torch restatement of
``examples/tut_5_awacs.py``; the reference's ``tutorial/tut_5_1.c``).

A fleet of replications of a 200-target scenario: the targets fly random
legs as ``count=N`` processes of one block, and a prioritized radar
process dwells every ``awacs.DWELL``, scoring every target with the
detection MLP; detections per dwell are pooled across replications.  On
the card the legs run in the AWACS chunk kernel and each dwell in the
dwell kernel (the MLP fused in); ``main`` runs there unless the caller
asks for the CPU (``device="cpu"``, the plain engine).
"""

from __future__ import annotations

from cimba_tpu_torch.models import awacs
from cimba_tpu_torch.runner import experiment
from cimba_tpu_torch.stats import summary as sm

N_TARGETS = 200
T_END = 20.0
SEED = 2026


def main(R: int = 8, n_targets: int = N_TARGETS, t_end: float = T_END,
         device="cuda"):
    spec, _ = awacs.build(n_targets)  # NN scoring is the default
    res = experiment.run_experiment(spec, awacs.params(t_end), R,
                                    seed=SEED, device=device)
    sims = res.sims
    assert int(res.n_failed) == 0, "replications failed"
    det = sm.merge_tree(sims.user["detections"])
    per_dwell = float(sm.mean(det))
    dwells = int(sims.user["dwells"].sum())
    # targets start at the arena center, well inside detection range: the
    # scorer must see most of them each dwell
    assert per_dwell > 0.5 * n_targets, per_dwell
    assert dwells >= R * (t_end / awacs.DWELL - 1)
    print(f"{R} replications x {n_targets} targets, {dwells} dwells, "
          f"{per_dwell:.1f} detections/dwell")
    return per_dwell


if __name__ == "__main__":
    main()
