"""The job shop in the f32 profile: ``jobshop.build()`` against the
reference, the whole run and a run truncated at ``max_steps`` (the cases
of tests/test_torch_jobshop.py, one compiled reference a file)."""

import torch

from test_torch_jobshop import check_matches_reference, check_truncated_run

torch.set_num_threads(1)


def test_matches_reference():
    check_matches_reference("f32", 8.0)


def test_truncated_run_matches_reference():
    check_truncated_run("f32", 8.0)
