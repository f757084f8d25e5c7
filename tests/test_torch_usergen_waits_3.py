"""The waits specs of ``tools/usergen.py`` (``waits=True``), part three:
seeds 16 (the lazy cancel) and 21 (10 processes: the generated kernel's
wakes and words in registers) in f64, 21 in f32, against cimba_tpu as in
``test_torch_usergen_waits.py``, and seed 21's blocks replayed bit for
bit."""

import torch

from cimba_tpu_torch.core import process as pr
from test_torch_usergen_waits import check_matches_reference, check_replays

torch.set_num_threads(1)


def test_lazy_cancel_matches_reference():
    _, out = check_matches_reference(16)
    assert bool((out.user["woke_sig"] != 99).all())


def test_register_layout_matches_reference():
    spec, _ = check_matches_reference(21)
    assert spec.n_procs == 10


def test_f32_matches_reference():
    check_matches_reference(21, "f32")


def test_blocks_replay_bit_for_bit():
    check_replays(21)
