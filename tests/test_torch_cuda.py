"""The CUDA chunk kernel on the card (skips without one).

Run on a machine with an NVIDIA card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The kernel (csrc/mm1_chunk.cu) and the plain engine run the same IEEE
operations on the same lanes (the kernel is built with --fmad=false and
both take log1p from CUDA's math library), so every leaf must be equal.
"""

import pytest
import torch

from cimba_tpu_torch import config, interop, tree
from cimba_tpu_torch.core import kernel_run, loop
from cimba_tpu_torch.models import mm1

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("t_end", [None, 40.0])
@pytest.mark.parametrize("prof", ["f32", "f64"])
def test_kernel_matches_plain_engine(card, prof, t_end):
    """Whole run, and with a horizon (the kernel's own t_end check)."""
    with config.profile(prof):
        spec, _ = mm1.build(record=False)
        s0 = loop.init_sim(spec, 2026, torch.arange(512), mm1.params(80),
                           device=card)
        run = kernel_run.make_kernel_run(spec, t_end=t_end, chunk_steps=32)
        ker = run(s0)
        pla = loop.make_run(spec, t_end=t_end)(s0)
        torch.cuda.synchronize()
    assert run.launches > 0
    assert interop.diff_leaves(tree.leaves(pla), tree.leaves(ker), 0.0) == []
    if t_end is not None:  # the horizon cut the run short
        assert bool((ker.clock <= t_end).all())
        assert not bool(ker.done.all())
