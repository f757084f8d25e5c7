"""Seeded user specs over the ported toolkit: plain engine against
cimba_tpu, and the tracer's replay against the blocks.

``cimba_tpu_torch.tools.usergen.build(seed, lib)`` writes one random
model with the DSL only (an object queue with the fused verbs, one or
two pools chosen by ``cmd.select``, a buffer, a condition whose
predicate reads its waiter's own local, inline and command releases, an
explicit ``cond_signal``, ``jump``, ``exit``, ``api.stop`` and five
samplers), in either package: ``tests/test_kernel_fuzz.py``'s
``_build_fuzz`` is the model, without its resources, priority queues,
timers and spawn.  Each seed runs through ``jax.jit(jax.vmap(make_run))``
and the port's plain engine on the CPU (6 lanes, seed 11), leaf for leaf
(integers exact, floats within 1e-9 of each leaf's scale, f64; the first
seed here, the others in ``test_torch_usergen_fuzz_<seed>.py``, since
the reference's CPU compile of one spec takes ~20 s); and each
block of the spec, traced (``core.trace``) on the port's state part way
through the run, replays bit for bit as the block itself computes.
"""

import functools
import types

import jax
import jax.numpy as jnp
import pytest
import torch

import cimba_tpu.random as jcr
from cimba_tpu import config as jconfig
from cimba_tpu.core import api as japi
from cimba_tpu.core import cmd as jcmd
from cimba_tpu.core import loop as jloop
from cimba_tpu.core.model import Model as JModel
from cimba_tpu.stats import summary as jsm
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.core import process as pr
from cimba_tpu_torch.core import trace
from cimba_tpu_torch.tools import usergen

torch.set_num_threads(1)

SEEDS = (1, 2, 3, 4)
LANES, RUN_SEED, K = 6, 11, 40

JLIB = types.SimpleNamespace(
    Model=JModel, api=japi, cmd=jcmd, cr=jcr,
    zeros_i=lambda: jnp.zeros((), jnp.int32),
    real=lambda v: jnp.asarray(v, jconfig.REAL), where=jnp.where,
    empty=jsm.empty, add=jsm.add)


@functools.lru_cache(maxsize=None)
def ref_run(seed):
    with jconfig.profile("f64"):
        spec, _ = usergen.build(seed, JLIB)
        js = jax.jit(jax.vmap(lambda r: jloop.init_sim(
            spec, RUN_SEED, r)))(jnp.arange(LANES))
        out = jax.jit(jax.vmap(jloop.make_run(spec)))(js)
    return js, out


def check_plain_engine_matches_reference(seed):
    js, jout = ref_run(seed)
    with tconfig.profile("f64"):
        spec, n_items = usergen.build(seed, usergen.torch_lib())
        ts = tloop.init_sim(spec, RUN_SEED, torch.arange(LANES),
                            device="cpu")
        tout = tloop.make_run(spec)(ts)
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), 1e-9) == []
    assert int(tout.err.abs().sum()) == 0
    assert bool((tout.user["done_n"] == n_items).all())


def test_plain_engine_matches_reference():
    check_plain_engine_matches_reference(SEEDS[0])


@pytest.mark.parametrize("seed", SEEDS)
def test_trace_replays_every_block(seed):
    with tconfig.profile("f32" if seed % 2 else "f64"):
        spec, _ = usergen.build(seed, usergen.torch_lib())
        s = tloop.init_sim(spec, RUN_SEED, torch.arange(LANES), device="cpu")
        s = tloop.make_run(spec, max_steps=K)(s)
        for pc, blk in enumerate(spec.blocks):
            ir = trace.trace_block(spec, pc, s)
            p = torch.arange(LANES, dtype=torch.int32) % spec.n_procs
            sig = torch.zeros(LANES, dtype=torch.int32)
            a_sim, a_cmd = blk(s, p, sig)
            a_cmd = pr.normalize(a_cmd, LANES, s.clock.device,
                                 s.clock.dtype)
            b_sim, b_cmd = trace.replay(spec, ir, s, p, sig)
            for (n, x), (_, y) in zip(trace.named_leaves(a_sim),
                                      trace.named_leaves(b_sim)):
                assert x.dtype == y.dtype and torch.equal(x, y), (pc, n)
            for x, y in zip(a_cmd, b_cmd):
                assert x.dtype == y.dtype and torch.equal(x, y), pc
        for c in spec.conditions:
            ir = trace.trace_predicate(spec, c.id, s)
            pid = torch.arange(LANES, dtype=torch.int32) % spec.n_procs
            want = c.predicate(s, pid)
            vals = trace.eval_nodes(
                ir.nodes, lambda name, i: dict(trace.named_leaves(s))[name]
                .reshape(LANES, -1)[:, i], pid, None, LANES, s.clock.device)
            assert torch.equal(vals[ir.out], want)
