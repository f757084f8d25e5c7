"""Observer forwarding on a binary resource, in both packages.

A condition declared ``observes=[resource]`` is re-evaluated at every
signal of the resource's guard: a release, and the drop of a holder's
resource at its exit.  The reference's three cases
(``tests/test_observers.py``) restated in the port, each run to t=100
by the reference's ``make_run`` through ``jax.jit(jax.vmap(...))`` and
by the port's plain engine on the CPU (4 lanes, seed 7, f64), leaf for
leaf with ``interop.diff_leaves`` (integers exact, floats within 1e-9
of each leaf's scale), and the reference's own assertions on the
port's state.
"""

import functools

import jax
import jax.numpy as jnp
import torch

import cimba_tpu_torch.random as tcr
from cimba_tpu import config as jconfig
from cimba_tpu.core import api as japi
from cimba_tpu.core import cmd as jcmd
from cimba_tpu.core import loop as jloop
from cimba_tpu.core.model import Model as JModel
import cimba_tpu.random as jcr
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import api as tapi
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.core import process as pr
from cimba_tpu_torch.core.model import Model as TModel

torch.set_num_threads(1)

LANES, SEED, T_END, RTOL = 4, 7, 100.0, 1e-9

JAX = dict(Model=JModel, api=japi, cmd=jcmd, cr=jcr)
TORCH = dict(Model=TModel, api=tapi, cmd=pr, cr=tcr)


def build(lib, case):
    """``release``: a holder grabs the resource, works a drawn time and
    releases it; a watcher waits on "the resource is free", a condition
    that observes the resource (``observe``) or not (``strand``); nobody
    signals it.  ``drop``: the holder exits without releasing."""
    Model, api, cmd, cr = lib["Model"], lib["api"], lib["cmd"], lib["cr"]
    m = Model(f"obs_{case}", n_ilocals=1, event_cap=4)
    res = m.resource("res", record=False)
    c = m.condition("free_watch",
                    lambda sim, pid: sim.resources.holder[..., res.id] < 0,
                    observes=() if case == "strand" else [res])

    @m.block
    def h_acquire(sim, p, sig):
        return sim, cmd.acquire(res.id, next_pc=h_work.pc)

    @m.block
    def h_work(sim, p, sig):
        if case == "drop":
            return sim, cmd.hold(3.0, next_pc=h_release.pc)
        sim, t = api.draw(sim, cr.exponential, 2.0)
        return sim, cmd.hold(t, next_pc=h_release.pc)

    @m.block
    def h_release(sim, p, sig):
        if case == "drop":
            return sim, cmd.exit_()  # never releases: the drop signals
        return sim, cmd.release(res.id, next_pc=h_done.pc)

    @m.block
    def h_done(sim, p, sig):
        return sim, cmd.exit_()

    @m.block
    def w_wait(sim, p, sig):
        return sim, cmd.cond_wait(c.id, next_pc=w_saw.pc)

    @m.block
    def w_saw(sim, p, sig):
        sim = api.add_local_i(sim, p, 0, 1)
        return sim, cmd.exit_()

    m.process("holder", entry=h_acquire, prio=1)
    m.process("watcher", entry=w_wait, prio=0)
    return m.build()


@functools.lru_cache(maxsize=None)
def ref(case):
    with jconfig.profile("f64"):
        spec = build(JAX, case)
        js = jax.vmap(lambda r: jloop.init_sim(spec, SEED, r))(
            jnp.arange(LANES))
        return jax.jit(jax.vmap(jloop.make_run(spec, t_end=T_END)))(js)


def run(case):
    jout = ref(case)
    with tconfig.profile("f64"):
        spec = build(TORCH, case)
        ts = tloop.init_sim(spec, SEED, torch.arange(LANES), device="cpu")
        out = tloop.make_run(spec, t_end=T_END)(ts)
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(out), RTOL) == []
    return out


def test_release_wakes_observer_waiter():
    out = run("observe")
    assert bool((out.procs.status[:, 1] == pr.FINISHED).all())
    assert bool((out.procs.locals_i[:, 1, 0] == 1).all())
    assert int(out.err.abs().sum()) == 0


def test_without_observer_the_waiter_strands():
    out = run("strand")
    assert bool((out.procs.status[:, 0] == pr.FINISHED).all())
    assert bool((out.procs.status[:, 1] != pr.FINISHED).all())
    assert bool((out.procs.locals_i[:, 1, 0] == 0).all())


def test_drop_on_exit_forwards_too():
    out = run("drop")
    assert bool((out.procs.status[:, 1] == pr.FINISHED).all())
    assert bool((out.procs.locals_i[:, 1, 0] == 1).all())
    assert int(out.err.abs().sum()) == 0
