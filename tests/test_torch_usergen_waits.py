"""The waits specs of ``tools/usergen.py`` (``waits=True``): the plain
engine against cimba_tpu, and the tracer's replay against the blocks.

``usergen.build(seed, lib, waits=True)`` writes a random model of the
waits and the event-handle API (a dispatcher joining workers by
``wait_process``, one stopped and one finished already; a watcher on a
user event that a controller reschedules, reprioritizes or cancels,
eagerly, lazily or as the lane's last activity; a process's timers
counted, found and cancelled by pattern; a timeout cancelled by handle;
``priority_set`` of a pended claimant; ``pqueue_cancel`` freeing a
blocked putter, ``pqueue_reprioritize`` and ``queue_position``).  Each
seed runs through ``jax.jit(jax.vmap(make_run))`` and the port's plain
engine on the CPU (6 lanes, seed 11) to the end, leaf for leaf (integers
exact, floats within 1e-9 of each leaf's scale in f64, 2e-5 in f32):
seeds 1 (the draining cancel) and 2 (a reschedule) in f64 and 3 in f32
here, 4, 7, 5 and 16, 21, 21 in ``_2`` and ``_3``; every block of one
seed a file, traced part way through a run, replays bit for bit.
"""

import functools
import types

import jax
import jax.numpy as jnp
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

LANES, RUN_SEED, K = 6, 11, 12
RTOL = {"f64": 1e-9, "f32": 2e-5}

JLIB = types.SimpleNamespace(
    Model=JModel, api=japi, cmd=jcmd, cr=jcr,
    zeros_i=lambda: jnp.zeros((), jnp.int32),
    real=lambda v: jnp.asarray(v, jconfig.REAL), where=jnp.where,
    empty=jsm.empty, add=jsm.add, floor=jnp.floor,
    i32=lambda x: jnp.asarray(x).astype(jnp.int32),
    real_of=lambda x: jnp.asarray(x).astype(jconfig.REAL),
    select_sim=lambda pred, a, b: jax.tree.map(
        lambda x, y: jnp.where(pred, x, y), a, b))


@functools.lru_cache(maxsize=None)
def check_matches_reference(seed, prof="f64"):
    """The seed's spec to the end in both packages, leaf for leaf;
    returns the port's spec and final state."""
    with jconfig.profile(prof):
        jspec = usergen.build(seed, JLIB, waits=True)[0]
        js = jax.jit(jax.vmap(lambda r: jloop.init_sim(
            jspec, RUN_SEED, r)))(jnp.arange(LANES))
        jout = jax.jit(jax.vmap(jloop.make_run(jspec)))(js)
    with tconfig.profile(prof):
        spec = usergen.build(seed, usergen.torch_lib(), waits=True)[0]
        ts = tloop.init_sim(spec, RUN_SEED, torch.arange(LANES),
                            device="cpu")
        out = tloop.make_run(spec)(ts)
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(out), RTOL[prof]) == []
    assert int(out.err.abs().sum()) == 0
    # every lane ran to its end: each process finished, each join counted
    assert bool((out.procs.status == pr.FINISHED).all())
    u = out.user
    assert bool((u["stopped"] == 1).all())
    assert bool((u["pat"] == 1).all())
    return spec, out


def check_replays(seed, prof="f64"):
    """Every block, traced on the state after K events, replays as the
    block itself computes, for every pid and the signals the blocks read
    (SUCCESS, STOPPED, CANCELLED, a timer's 8, TIMEOUT)."""
    with tconfig.profile(prof):
        spec = usergen.build(seed, usergen.torch_lib(), waits=True)[0]
        s = tloop.init_sim(spec, RUN_SEED, torch.arange(LANES), device="cpu")
        s = tloop.make_run(spec, max_steps=K)(s)
        sigs = torch.tensor([0, -3, -4, 8, usergen.TIMEOUT],
                            dtype=torch.int32)
        for pc, blk in enumerate(spec.blocks):
            ir = trace.trace_block(spec, pc, s)
            for shift in range(0, spec.n_procs, 3):
                p = ((torch.arange(LANES, dtype=torch.int32) + shift)
                     % spec.n_procs)
                sig = sigs[(torch.arange(LANES) + shift) % len(sigs)]
                a_sim, a_cmd = blk(s, p, sig)
                a_cmd = pr.normalize(a_cmd, LANES, s.clock.device,
                                     s.clock.dtype)
                b_sim, b_cmd = trace.replay(spec, ir, s, p, sig)
                for (n, x), (_, y) in zip(trace.named_leaves(a_sim),
                                          trace.named_leaves(b_sim)):
                    assert x.dtype == y.dtype and torch.equal(x, y), (pc, n)
                for x, y in zip(a_cmd, b_cmd):
                    assert x.dtype == y.dtype and torch.equal(x, y), pc


def test_draining_cancel_matches_reference():
    """Seed 1: the controller's lazy cancel is the lane's last activity;
    the stranded watcher still wakes with CANCELLED past t=60."""
    _, out = check_matches_reference(1)
    assert bool((out.user["woke_sig"] == pr.CANCELLED).all())
    assert bool((out.user["woke_t"] > 60.0).all())
    assert bool((out.user["fired"] == 0).all())


def test_reschedule_matches_reference():
    spec, out = check_matches_reference(2)
    assert spec.n_procs > 10  # the wakes and words in shared columns


def test_f32_matches_reference():
    """Seed 3 in f32: 14 processes, the draining cancel, the priority
    queue's cancel freeing the blocked putter, the positions read."""
    _, out = check_matches_reference(3, "f32")
    assert bool((out.user["freed"] == 1).all())
    assert bool((out.user["pos"] == 11).all())


def test_blocks_replay_bit_for_bit():
    check_replays(3)
