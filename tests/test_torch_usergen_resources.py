"""Seeded user specs of binary resources, preemption and user events:
the port's plain engine against cimba_tpu.

``cimba_tpu_torch.tools.usergen.build(seed, lib, resources=True)`` writes
a random model with a binary resource taken by ``acquire`` (plain or
fused, one under a timeout) and by ``preempt`` (plain or fused, one under
a timeout, so a pended preempt is aborted), ``api.release`` where the
caller still holds it, ``api.resource_holder``, a pool taken by
``pool_acquire`` and mugged by ``pool_preempt`` (plain under a timeout,
or fused), and a user event scheduled by ``api.schedule`` whose handler
stops the process the event's subject names.  Each seed runs through
``jax.jit(jax.vmap(make_run))`` and the port's plain engine on the CPU
(4 lanes, seed 11) to t=20, leaf for leaf (integers exact, floats within
1e-9 of each leaf's scale in f64, 2e-5 in f32).  Seed 1 is here, with
the generated kernel's header and the refusal of a spec past the
generated family's process limit; seed 2, a
reference state carried in and the tracer's replay in
``test_torch_usergen_resources_2.py``; seed 3 and the f32 profile in
``test_torch_usergen_resources_3.py`` (one reference compile, ~15 s, a
case).
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
from cimba_tpu_torch.core import kernel_run
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.core.model import Model as TModel
from cimba_tpu_torch.tools import usergen

torch.set_num_threads(1)

LANES, RUN_SEED, T_END = 4, 11, 20.0
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
def ref_run(seed, prof):
    """The reference's initial state, compiled run and end at T_END."""
    with jconfig.profile(prof):
        spec, _ = usergen.build(seed, JLIB, resources=True)
        js = jax.jit(jax.vmap(lambda r: jloop.init_sim(
            spec, RUN_SEED, r)))(jnp.arange(LANES))
        run = jax.jit(jax.vmap(jloop.make_run(spec, t_end=T_END)))
        return js, run, run(js)


def check_matches_reference(seed, prof="f64"):
    js, _, jout = ref_run(seed, prof)
    with tconfig.profile(prof):
        spec, _ = usergen.build(seed, usergen.torch_lib(), resources=True)
        ts = tloop.init_sim(spec, RUN_SEED, torch.arange(LANES),
                            device="cpu")
        tout = tloop.make_run(spec, t_end=T_END)(ts)
    assert [x.dtype for x in jax.tree.leaves(js)] == [
        x.dtype for x in interop.sim_to_numpy(ts)]
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout),
                               RTOL[prof]) == []
    assert int(tout.err.abs().sum()) == 0
    # the verbs ran: kicks of resource holders and timeouts; the handler
    # (argument 100) ran in every lane, and stopped a process
    u = tout.user
    assert int(u["kicked"].sum()) > 0 and int(u["timeouts"].sum()) > 0
    assert bool((u["grants"] >= 100).all())
    assert bool((tout.procs.exit_sig == -3).any())
    return tout


def test_plain_engine_matches_reference():
    check_matches_reference(1)


def test_generated_kernel_header_and_spawn_refusal():
    """The spec takes the generated family, with the resource's verbs,
    the inline release, the stop by a computed pid, the event's insert
    and the handler; a spec past the process limit is refused, naming
    its count."""
    with tconfig.profile("f64"):
        spec, _ = usergen.build(1, usergen.torch_lib(), resources=True)
        s = tloop.init_sim(spec, RUN_SEED, torch.arange(2), device="cpu")
        lay, fn, table = kernel_run.kernel_for(spec, s)
    assert fn is kernel_run.gen_chunk
    h = lay["header"]
    for piece in ("NR = 1, NH = 1", "MUG = true",
                  "release_resource<0>(s, w, int(", "stop_process(s, w, int(",
                  "schedule_event(s, w,", "s.holder[0]", "hdl0(",
                  "dice(b"):
        assert piece in h, piece
    names = [n for n, _, _ in table]
    assert names[names.index("resources.holder") - 1] == "guards.next_seq"
    # spawn pools are taken now; 33 processes, one past the generated
    # family's limit, are refused, naming the count
    m = TModel("spawner")
    m.process("p", entry=m.block(lambda sim, p, sig: None), count=33,
              start=False)
    with pytest.raises(NotImplementedError, match="33 processes"):
        kernel_run.kernel_for(m.build(), s)
