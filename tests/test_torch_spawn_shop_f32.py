"""The spawn shop in the f32 profile (``sum_wait`` is float64 in both
packages, as the reference's is): the port against cimba_tpu as in
``test_torch_spawn_shop.py``, and the example's gates on
``run_experiment(..., device="cpu")``."""

import torch

from cimba_tpu_torch.examples import spawn_shop as ss
from test_torch_spawn_shop import check_gates, check_matches_reference

torch.set_num_threads(1)


def test_matches_reference_f32():
    out = check_matches_reference("f32")
    assert out.user["sum_wait"].dtype == torch.float64


def test_run_experiment_on_cpu_gates():
    """``run`` goes through ``runner.experiment.run_experiment`` on the
    CPU: no failed lane, the example's and the cell's gates, no launch."""
    res = ss.run(4, device="cpu")
    assert int(res.n_failed) == 0 and res.launches == 0
    check_gates(res.sims)
    assert int(res.total_events) == int(res.sims.n_events.sum())
