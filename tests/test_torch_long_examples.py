"""The long-run examples of the port at a tiny size on the CPU, and the
long-run entry points' device rule.

``cimba_tpu_torch.examples``' ``checkpointed_run`` (saved half way,
restored, bit for bit the run never stopped), ``large_r_stream`` (waves
folded into pooled statistics), ``mm1_experiment`` and ``tut_5_awacs``
each run through their ``main`` with ``device="cpu"`` and shapes cut to
a few lanes; each checks its own result.  The chunked, streamed and
regrown runs, ``checkpoint.restore`` and the chunk family default to the
card and raise without one (``torch.cuda.is_available`` patched false):
none of them drops to the CPU on its own.
"""

import pytest
import torch

from cimba_tpu_torch.core import loop
from cimba_tpu_torch.examples import (checkpointed_run, large_r_stream,
                                      mm1_experiment, tut_5_awacs)
from cimba_tpu_torch.models import mm1
from cimba_tpu_torch.runner import experiment

torch.set_num_threads(1)


def test_checkpointed_run(tmp_path):
    assert checkpointed_run.main(R=4, n_objects=1000, t_half=20.0,
                                 device="cpu",
                                 path=str(tmp_path / "half.npz"))


def test_large_r_stream():
    st, _ = large_r_stream.main(R=48, wave=16, device="cpu", quiet=True)
    assert st.n_waves == 3 and int(st.total_events) > 0


def test_mm1_experiment():
    pooled = mm1_experiment.main(R=8, n_objects=50, device="cpu")
    assert float(pooled.n) == 8 * 50


def test_tut_5_awacs():
    assert tut_5_awacs.main(R=2, n_targets=8, t_end=3.0, device="cpu") > 4


def test_long_run_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, _ = mm1.build(record=False)
    calls = (
        lambda: experiment.run_experiment_chunked(spec, mm1.params(4), 4),
        lambda: experiment.run_experiment_stream(spec, mm1.params(4), 4),
        lambda: experiment.run_experiment_regrow(spec, mm1.params(4), 4),
        lambda: large_r_stream.main(R=4, quiet=True),
        lambda: checkpointed_run.main(R=2, n_objects=10),
        lambda: loop.init_sim(spec, 1, torch.arange(2), t_stop=5.0),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
