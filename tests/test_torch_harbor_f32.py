"""Tutorial 4's LNG harbor in the f32 profile (``depth`` and ``phase``
stay float64, as the reference's): the port against cimba_tpu as in
``test_torch_harbor.py``, and the tutorial's gates on
``run_experiment(..., device="cpu")``."""

import torch

from cimba_tpu_torch.examples import tut_4_harbor as thb
from cimba_tpu_torch.runner import experiment
from test_torch_harbor import SEED, check_matches_reference

torch.set_num_threads(1)


def test_matches_reference_f32():
    check_matches_reference("f32")


def test_run_experiment_on_cpu_gates():
    """The tutorial's gates at a cut horizon: no failed lane, every
    ship that sailed returned its tugs and berth, a positive time in
    port."""
    res = experiment.run_experiment(thb.build(), thb.params(), 4, seed=SEED,
                                    t_end=80.0, device="cpu")
    assert int(res.n_failed) == 0
    sims = res.sims
    gone = (sims.procs.status == 2)[:, None, :].expand_as(sims.pools.held)
    assert float(sims.pools.held.abs().masked_select(gone).sum()) == 0.0
    assert int(sims.user["sailed"].sum()) > 0
    pooled = experiment.pooled_summary(thb.summary_path(sims))
    assert float(pooled.m1) > 0.0
