"""Tutorial 3's jockeying park in the f32 profile (the tickets are
float64 where the reference's are, and float32 once a command carries
them): the port against cimba_tpu as in ``test_torch_tut3.py``, and the
tutorial's gates on ``run_experiment(..., device="cpu")``."""

import torch

from cimba_tpu_torch.examples import tut_3_balking as t3
from test_torch_tut3 import check_matches_reference, check_tutorial_gates

torch.set_num_threads(1)


def test_matches_reference_f32():
    check_matches_reference("f32")


def test_run_experiment_on_cpu_gates():
    """``run`` goes through ``runner.experiment.run_experiment`` on the
    CPU: no failed lane, the tutorial's gates, every visitor gone by the
    horizon."""
    res = t3.run(16, device="cpu")
    assert int(res.n_failed) == 0 and res.launches == 0
    check_tutorial_gates(res.sims)
    assert bool((res.sims.procs.status[:, :t3.N_VISITORS] == 2).all())
    assert int(res.total_events) == int(res.sims.n_events.sum())
