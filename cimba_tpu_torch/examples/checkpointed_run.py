"""Checkpointed run (torch restatement of ``examples/checkpointed_run.py``):
an M/M/1 experiment saved half way and resumed, bit for bit the run
that was never stopped.

The Sim is a replication's whole state, its Threefry counter included, so
``runner.checkpoint.save`` at t=5000 and ``restore`` give a Sim that the
second half of the run continues exactly as it continues the one in
memory.  ``main`` runs on the card unless the caller asks for the CPU
(``device="cpu"``); ``R``, ``n_objects`` and the half-way horizon
shrink it for a quick run.
"""

from __future__ import annotations

import os
import tempfile

import torch

from cimba_tpu_torch import config, tree
from cimba_tpu_torch.core import kernel_run, loop
from cimba_tpu_torch.models import mm1
from cimba_tpu_torch.runner import checkpoint as ckpt

SEED = 99


def main(R: int = 64, n_objects: int = 1_000_000, t_half: float = 5_000.0,
         device="cuda", path=None):
    spec, _ = mm1.build()
    dev = config.resolve_device(device)
    sims = loop.init_sim(spec, SEED, torch.arange(R), mm1.params(n_objects),
                         device=dev)
    first = kernel_run.make_kernel_run(spec, t_end=t_half)
    second = kernel_run.make_kernel_run(spec, t_end=2 * t_half)
    half = first(sims)
    if path is None:
        path = os.path.join(tempfile.mkdtemp(), "experiment.npz")
    ckpt.save(path, half)
    print(f"checkpointed {R} replications at t={t_half:g} -> {path}")
    resumed = second(ckpt.restore(path, half))
    direct = second(half)
    same = all(torch.equal(a, b) for a, b in
               zip(tree.leaves(resumed), tree.leaves(direct)))
    print(f"resumed to t={2 * t_half:g}; bit-identical to the "
          f"uninterrupted run: {same}")
    assert same
    return same


if __name__ == "__main__":
    main()
