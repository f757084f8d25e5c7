"""The spawn specs of ``tools/usergen.py`` (``spawn=True``), part three:
seed 2 (12 processes, one pool whose burst exhausts it) in f64 and seed
4 (23 processes, 9 guards, two pools) in f32, against cimba_tpu as in
``test_torch_usergen_spawn.py``."""

import torch

from test_torch_usergen_spawn import check_matches_reference

torch.set_num_threads(1)


def test_plain_engine_matches_reference():
    spec, _ = check_matches_reference(2)
    assert spec.n_procs == 12 and len(spec.spawn_types) == 1


def test_plain_engine_matches_reference_f32():
    spec, _ = check_matches_reference(4, "f32")
    assert spec.n_procs == 23 and spec.n_guards == 9
