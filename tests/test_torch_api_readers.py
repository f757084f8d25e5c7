"""The port's pure readers (``cimba_tpu_torch.core.api``) against
``cimba_tpu.core.api`` on seeded states.

Each reference state is the reference's own run part way (the cookbook's
balking M/M/1: an object queue, a waiting server, locals; the tutorial
harbor: two pools with holders, float locals, a prio-10 tide, finished
ships), carried into the port by ``interop.sim_from_numpy``.  Each reader
runs lane-batched in the port and per lane (``jax.vmap``) in the
reference, with a pid a lane; values are compared exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.core import api as japi
from cimba_tpu.core import loop as jloop
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop, tree
from cimba_tpu_torch.core import api as tapi
from cimba_tpu_torch.examples import cookbook_balking as tcb
from cimba_tpu_torch.examples import tut_4_harbor as thb
from examples import cookbook_balking as jcb
from examples import tut_4_harbor as jhb

torch.set_num_threads(1)

LANES = 8


@functools.lru_cache(maxsize=None)
def states():
    """(reference spec, refs, reference Sim, port spec, refs, port Sim)
    of each model, part way through a run (f64)."""
    out = {}
    with jconfig.profile("f64"), tconfig.profile("f64"):
        jspec, jq = jcb.build()
        params = (1 / 0.9, 1.0, 8.0, 60)
        js = jax.jit(jax.vmap(lambda r: jloop.make_run(jspec, max_steps=47)(
            jloop.init_sim(jspec, 7, r, params))))(jnp.arange(LANES))
        tspec, tq = tcb.build()
        ts = interop.sim_from_numpy([np.asarray(x) for x in
                                     jax.tree.leaves(js)], tspec,
                                    tcb.params(60), device="cpu")
        out["balking"] = (jspec, {"q": jq}, js, tspec, {"q": tq}, ts)
        jspec = jhb.build()
        js = jax.jit(jax.vmap(lambda r: jloop.make_run(jspec, max_steps=60)(
            jloop.init_sim(jspec, 4, r))))(jnp.arange(LANES))
        tspec = thb.build()
        ts = interop.sim_from_numpy([np.asarray(x) for x in
                                     jax.tree.leaves(js)], tspec, None,
                                    device="cpu")
        out["harbor"] = (jspec, None, js, tspec, None, ts)
    return out


def pids(spec):
    return np.arange(LANES) % spec.n_procs


def vmapped(fn, js, p):
    return np.asarray(jax.vmap(fn)(js, jnp.asarray(p, jnp.int32)))


READERS = {
    # name: (model, reference (sim, p) -> value, port (sim, p, refs))
    "got": ("balking", lambda s, p, r: japi.got(s, p),
            lambda s, p, r: tapi.got(s, p)),
    "local_i": ("balking", lambda s, p, r: japi.local_i(s, p, 0),
                lambda s, p, r: tapi.local_i(s, p, 0)),
    "local_f": ("harbor", lambda s, p, r: japi.local_f(s, p, 1),
                lambda s, p, r: tapi.local_f(s, p, 1)),
    "queue_length": ("balking", lambda s, p, r: japi.queue_length(s, r["q"]),
                     lambda s, p, r: tapi.queue_length(s, r["q"])),
    "queue_space": ("balking", lambda s, p, r: japi.queue_space(s, r["q"]),
                    lambda s, p, r: tapi.queue_space(s, r["q"])),
    "pool_level": ("harbor", lambda s, p, r: japi.pool_level(s, 0),
                   lambda s, p, r: tapi.pool_level(s, 0)),
    "pool_in_use": ("harbor", lambda s, p, r: japi.pool_in_use(s, r["pool"]),
                    lambda s, p, r: tapi.pool_in_use(s, r["pool"])),
    "pool_held": ("harbor", lambda s, p, r: japi.pool_held(s, 1, p),
                  lambda s, p, r: tapi.pool_held(s, 1, p)),
    "proc_priority": ("harbor", lambda s, p, r: japi.proc_priority(s, p),
                      lambda s, p, r: tapi.proc_priority(s, p)),
    "proc_status": ("harbor", lambda s, p, r: japi.proc_status(s, p),
                    lambda s, p, r: tapi.proc_status(s, p)),
    "set_local_i": ("balking",
                    lambda s, p, r: japi.set_local_i(s, p, 0, 41)
                    .procs.locals_i,
                    lambda s, p, r: tapi.set_local_i(s, p, 0, 41)
                    .procs.locals_i),
    "fail": ("harbor",
             lambda s, p, r: japi.fail(s, p % 2 == 0).err,
             lambda s, p, r: tapi.fail(s, p % 2 == 0).err),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_matches_reference(name):
    model, jfn, tfn = READERS[name]
    jspec, jrefs, js, tspec, trefs, ts = states()[model]
    if model == "harbor":
        jrefs = {"pool": jspec.pools[0]}
        trefs = {"pool": tspec.pools[0]}
    p = pids(tspec)
    want = vmapped(lambda s, q: jfn(s, q, jrefs), js, p)
    got = tfn(ts, torch.as_tensor(p, dtype=torch.int32), trefs)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_user_reader_returns_the_user_state():
    *_, ts = states()["balking"]
    assert tapi.user(ts) is ts.user
    _, _, js, *_ = states()["balking"]
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(japi.user)(js)["balked"]),
        tree.leaves(tapi.user(ts)["balked"])[0].numpy())


def test_readers_that_need_a_ref_refuse_a_bare_id():
    *_, ts = states()["harbor"]
    with pytest.raises(TypeError):
        tapi.pool_in_use(ts, 0)
    *_, ts = states()["balking"]
    with pytest.raises(TypeError):
        tapi.queue_space(ts, 0)
