"""The resource specs of ``tools/usergen.py`` (``resources=True``), part
two: seed 2 against cimba_tpu as in ``test_torch_usergen_resources.py``
(its mugger mugs); the reference's end state, with its ``resources``
leaves, carried into the port by ``interop.sim_from_numpy`` and run on
by the port past the reference's horizon: the port's own run to that
horizon; and every block and the handler of seed 2, traced on the
port's state part way through a run, replayed bit for bit as the block
or handler itself computes, for every pid and the signals the blocks
branch on."""

import jax
import numpy as np
import torch

from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.core import process as pr
from cimba_tpu_torch.core import trace
from cimba_tpu_torch.tools import usergen
from test_torch_usergen_resources import (LANES, RTOL, RUN_SEED, T_END,
                                          check_matches_reference, ref_run)

torch.set_num_threads(1)


def test_plain_engine_matches_reference():
    out = check_matches_reference(2)
    assert int(out.user["mugged"].sum()) > 0


def test_reference_state_carried_in():
    _, _, jout = ref_run(2, "f64")
    with tconfig.profile("f64"):
        spec, _ = usergen.build(2, usergen.torch_lib(), resources=True)
        mid = interop.sim_from_numpy(
            [np.asarray(x) for x in jax.tree.leaves(jout)], spec,
            device="cpu")
        assert mid.resources.holder.shape == (LANES, 1)
        assert interop.diff_leaves(jax.tree.leaves(jout),
                                   interop.sim_to_numpy(mid), 0.0) == []
        on = tloop.make_run(spec, t_end=T_END + 10.0)(mid)
        ts = tloop.init_sim(spec, RUN_SEED, torch.arange(LANES),
                            device="cpu")
        own = tloop.make_run(spec, t_end=T_END + 10.0)(ts)
    assert interop.diff_leaves(interop.sim_to_numpy(own),
                               interop.sim_to_numpy(on), RTOL["f64"]) == []


def test_trace_replays_every_block_and_the_handler():
    with tconfig.profile("f64"):
        spec, _ = usergen.build(2, usergen.torch_lib(), resources=True)
        s = tloop.init_sim(spec, RUN_SEED, torch.arange(LANES), device="cpu")
        s = tloop.make_run(spec, t_end=12.0)(s)
        sigs = torch.tensor([0, usergen.TIMEOUT, -1], dtype=torch.int32)
        fns = [(f"block {pc}", blk, trace.trace_block(spec, pc, s))
               for pc, blk in enumerate(spec.blocks)]
        fns += [(f"handler {k}", h, trace.trace_handler(spec, k, s))
                for k, h in enumerate(spec.user_handlers)]
        for what, fn, ir in fns:
            for shift in range(spec.n_procs):
                p = ((torch.arange(LANES, dtype=torch.int32) + shift)
                     % spec.n_procs)
                sig = sigs[(torch.arange(LANES) + shift) % 3]
                a = fn(s, p, sig)
                b = trace.replay(spec, ir, s, p, sig)
                if not ir.cmd:  # a handler gives the Sim alone
                    a, b = (a, None), (b, None)
                else:
                    a = (a[0], pr.normalize(a[1], LANES, s.clock.device,
                                            s.clock.dtype))
                for (n, x), (_, y) in zip(trace.named_leaves(a[0]),
                                          trace.named_leaves(b[0])):
                    assert x.dtype == y.dtype and torch.equal(x, y), (what, n)
                if ir.cmd:
                    for x, y in zip(a[1], b[1]):
                        assert x.dtype == y.dtype and torch.equal(x, y), what
