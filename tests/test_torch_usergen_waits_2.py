"""The waits specs of ``tools/usergen.py`` (``waits=True``), part two:
seeds 4 (the eager cancel) and 7 (a reprioritize) in f64 and 5 in f32
against cimba_tpu as in ``test_torch_usergen_waits.py``, and seed 5's
blocks replayed bit for bit."""

import torch

from cimba_tpu_torch.core import process as pr
from test_torch_usergen_waits import check_matches_reference, check_replays

torch.set_num_threads(1)


def test_eager_cancel_matches_reference():
    """Seed 4: the controller cancels with the spec: where the event has
    not fired yet the watcher wakes with CANCELLED at the cancel, else it
    woke with SUCCESS at the fire."""
    _, out = check_matches_reference(4)
    u = out.user
    want = torch.where(u["fired"] == 1, pr.SUCCESS, pr.CANCELLED)
    assert bool((u["woke_sig"] == want).all())
    assert int((u["fired"] == 0).sum()) > 0


def test_reprioritize_matches_reference():
    _, out = check_matches_reference(7)
    assert bool((out.user["woke_sig"] == pr.SUCCESS).all())
    assert bool((out.user["fired"] == 1).all())


def test_f32_matches_reference():
    spec, out = check_matches_reference(5, "f32")
    assert spec.n_procs == 15


def test_blocks_replay_bit_for_bit():
    check_replays(5, "f32")
