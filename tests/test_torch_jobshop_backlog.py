"""The job shop with ``backlog=4.0`` (the maintenance process runs in
most lanes) against the reference in f64: the whole run and a run
truncated at ``max_steps`` (the cases of tests/test_torch_jobshop.py)."""

import torch

from test_torch_jobshop import check_matches_reference, check_truncated_run

torch.set_num_threads(1)


def test_matches_reference():
    out = check_matches_reference("f64", 4.0)
    assert bool((out.user["maintenance_runs"] >= 1).any())


def test_truncated_run_matches_reference():
    check_truncated_run("f64", 4.0)
