"""Seeded user specs with the later verbs: plain engine against
cimba_tpu, and the tracer's replay against the blocks.

``cimba_tpu_torch.tools.usergen.build(seed, lib, timers=True)`` writes
a random model with a priority queue (puts at a drawn priority, plain or
fused gets), a timeout on each consumer's plain pool acquire and on the
drain's plain buffer get (a timer, ``timers_clear`` on success, kept or
dropped by a select of the whole Sim), and a watcher that interrupts a
consumer it draws; ``usergen.abort_spec`` a model whose waits are
aborted every few events (a pool waiter's timeout rolls back its partial
grab, a buffer waiter's interrupt reports its partial take).  One seed
and the abort spec run through ``jax.jit(jax.vmap(make_run))`` and the
port's plain engine on the CPU (6 lanes, seed 11) to t=30, leaf for leaf
(integers exact, floats within 1e-9 of each leaf's scale, f64); every
block of three seeds and of the abort spec, traced on the port's state
part way through the run, replays bit for bit as the block itself
computes, for every pid and the signals the blocks branch on.
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

SEEDS = (5, 6, 7)
LANES, RUN_SEED, K, T_END = 6, 11, 40, 30.0

JLIB = types.SimpleNamespace(
    Model=JModel, api=japi, cmd=jcmd, cr=jcr,
    zeros_i=lambda: jnp.zeros((), jnp.int32),
    real=lambda v: jnp.asarray(v, jconfig.REAL), where=jnp.where,
    empty=jsm.empty, add=jsm.add, floor=jnp.floor,
    i32=lambda x: jnp.asarray(x).astype(jnp.int32),
    select_sim=lambda pred, a, b: jax.tree.map(
        lambda x, y: jnp.where(pred, x, y), a, b))

BUILDS = {f"usergent{s}": (lambda lib, s=s: usergen.build(
    s, lib, timers=True)[0]) for s in SEEDS}
BUILDS["abort"] = usergen.abort_spec


@functools.lru_cache(maxsize=None)
def ref_run(name, prof):
    with jconfig.profile(prof):
        spec = BUILDS[name](JLIB)
        js = jax.jit(jax.vmap(lambda r: jloop.init_sim(
            spec, RUN_SEED, r)))(jnp.arange(LANES))
        out = jax.jit(jax.vmap(jloop.make_run(spec, t_end=T_END)))(js)
    return js, out


def check_plain_engine_matches_reference(name, prof="f64"):
    js, jout = ref_run(name, prof)
    with tconfig.profile(prof):
        spec = BUILDS[name](usergen.torch_lib())
        ts = tloop.init_sim(spec, RUN_SEED, torch.arange(LANES),
                            device="cpu")
        tout = tloop.make_run(spec, t_end=T_END)(ts)
    rtol = {"f64": 1e-9, "f32": 2e-5}[prof]
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), rtol) == []
    assert int(tout.err.abs().sum()) == 0
    return tout


def test_plain_engine_matches_reference():
    out = check_plain_engine_matches_reference("usergent5")
    # the drain's timed-out gets kept partial takes
    assert float(out.user["partial"].sum()) > 0.0


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_trace_replays_every_block(name):
    with tconfig.profile("f32" if name.endswith("5") else "f64"):
        spec = BUILDS[name](usergen.torch_lib())
        s = tloop.init_sim(spec, RUN_SEED, torch.arange(LANES), device="cpu")
        s = tloop.make_run(spec, max_steps=K)(s)
        sigs = torch.tensor([0, usergen.TIMEOUT, usergen.INTERRUPTED],
                            dtype=torch.int32)
        for pc, blk in enumerate(spec.blocks):
            ir = trace.trace_block(spec, pc, s)
            for shift in range(spec.n_procs):
                p = ((torch.arange(LANES, dtype=torch.int32) + shift)
                     % spec.n_procs)
                sig = sigs[(torch.arange(LANES) + shift) % 3]
                a_sim, a_cmd = blk(s, p, sig)
                a_cmd = pr.normalize(a_cmd, LANES, s.clock.device,
                                     s.clock.dtype)
                b_sim, b_cmd = trace.replay(spec, ir, s, p, sig)
                for (n, x), (_, y) in zip(trace.named_leaves(a_sim),
                                          trace.named_leaves(b_sim)):
                    assert x.dtype == y.dtype and torch.equal(x, y), (pc, n)
                for x, y in zip(a_cmd, b_cmd):
                    assert x.dtype == y.dtype and torch.equal(x, y), pc
