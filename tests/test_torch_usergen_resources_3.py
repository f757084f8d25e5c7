"""The resource specs of ``tools/usergen.py`` (``resources=True``), part
three: seed 3 in f64 and seed 1 in f32 against cimba_tpu as in
``test_torch_usergen_resources.py``."""

import pytest
import torch

from test_torch_usergen_resources import check_matches_reference

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,prof", [(3, "f64"), (1, "f32")])
def test_plain_engine_matches_reference(seed, prof):
    check_matches_reference(seed, prof)
