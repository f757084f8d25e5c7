"""The spawn specs of ``tools/usergen.py`` (``spawn=True``), part two:
seed 13, the most processes the generated kernel takes (32: a door, a
watcher, 28 clients and 2 runners), against cimba_tpu as in
``test_torch_usergen_spawn.py``; and every block of the spec, traced on
the port's state part way through a run, replayed bit for bit as the
block itself computes, for a door's, a client's and a runner's pid."""

import torch

from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.core import process as pr
from cimba_tpu_torch.core import trace
from cimba_tpu_torch.tools import usergen
from test_torch_usergen_spawn import LANES, RUN_SEED, check_matches_reference

torch.set_num_threads(1)


def test_plain_engine_matches_reference():
    spec, out = check_matches_reference(13)
    assert spec.n_procs == 32 and len(spec.spawn_types) == 2


def test_blocks_replay_bit_for_bit():
    with tconfig.profile("f64"):
        spec, _ = usergen.build(13, usergen.torch_lib(), spawn=True)
        s = tloop.init_sim(spec, RUN_SEED, torch.arange(LANES), device="cpu")
        s = tloop.make_run(spec, max_steps=30)(s)
        sig = torch.zeros(LANES, dtype=torch.int32)
        for p0 in (0, 5, spec.n_procs - 1):
            p = torch.full((LANES,), p0, dtype=torch.int32)
            for pc, blk in enumerate(spec.blocks):
                a_sim, a_cmd = blk(s, p, sig)
                b_sim, b_cmd = trace.replay(
                    spec, trace.trace_block(spec, pc, s), s, p, sig)
                a_cmd = pr.normalize(a_cmd, LANES, s.clock.device,
                                     s.clock.dtype)
                for (n, x), (_, y) in zip(trace.named_leaves(a_sim),
                                          trace.named_leaves(b_sim)):
                    assert x.dtype == y.dtype and torch.equal(x, y), (pc, n)
                for x, y in zip(a_cmd, b_cmd):
                    assert x.dtype == y.dtype and torch.equal(x, y), pc
