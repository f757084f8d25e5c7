"""The port's audited stream against the reference's, trail row for row.

``run_experiment_stream(..., audit=True)`` on the port's plain engine
(``device="cpu"``) and on the reference (its XLA path), the same
geometry: R replications in waves, chunks of K events, ``poll_every``
4.  The trails must have the same rows (wave, chunk), the chunks a late
poll dispatches past the end included, and equal digests in these
classes:

* mm1 (f64: 16 replications of 15 objects in waves of 8, K=16): the
  i32 and i64 classes.  Its float classes are not compared: the port's
  log1p is not XLA's to the last place, so the f64 states differ in
  their last bits;
* a spec whose floats are exact in both packages (two processes holding
  a uniform draw on [0.5, 1.5) and summing it into a local, to t=12; 16
  replications in waves of 8, K=8, the clocks pooled), in f64 and f32:
  all four classes,
  the float classes too, because the test also shows the final states'
  float leaves bitwise equal.
"""

import functools
import types

import jax
import numpy as np
import pytest
import torch

import cimba_tpu.random as jcr
from cimba_tpu import config as jconfig
from cimba_tpu.core import api as japi
from cimba_tpu.core import cmd as jcmd
from cimba_tpu.core import loop as jloop
from cimba_tpu.core.model import Model as JModel
from cimba_tpu.models import mm1 as jmm1
from cimba_tpu.runner import experiment as jex
from cimba_tpu.stats import summary as jsm
from cimba_tpu_torch import config, interop
from cimba_tpu_torch.core import loop
from cimba_tpu_torch.models import mm1
from cimba_tpu_torch.runner import experiment as ex
from cimba_tpu_torch.stats import summary as sm
from cimba_tpu_torch.tools import usergen

torch.set_num_threads(1)

JLIB = types.SimpleNamespace(Model=JModel, api=japi, cmd=jcmd, cr=jcr)
R, WAVE, SEED = 16, 8, 5


def uni_spec(lib):
    m = lib.Model("unihold", n_flocals=1, event_cap=4)

    @m.block
    def tick(sim, p, sig):
        sim, dt = lib.api.draw(sim, lib.cr.uniform, 0.5, 1.5)
        sim = lib.api.set_local_f(sim, p, 0, lib.api.local_f(sim, p, 0)
                                  + dt)
        done = lib.api.clock(sim) > 12.0
        return sim, lib.cmd.select(done, lib.cmd.exit_(),
                                   lib.cmd.hold(dt, next_pc=tick.pc))

    m.process("t", entry=tick, count=2)
    return m.build()


@functools.lru_cache(maxsize=None)
def ref_trail(name, prof):
    with jconfig.profile(prof):
        if name == "mm1":
            spec, params, k = jmm1.build(record=False)[0], jmm1.params(15), 16
        else:
            spec, params, k = uni_spec(JLIB), None, 8
        st = jex.run_experiment_stream(
            spec, params, R, wave_size=WAVE, chunk_steps=k, seed=SEED,
            audit=True, **({} if name == "mm1" else dict(
                summary_path=lambda s: jax.vmap(
                    lambda c: jsm.add(jsm.empty(), c))(s.clock))))
        final = None
        if name == "uni":
            out = jax.jit(jax.vmap(jloop.make_run(spec)))(jax.vmap(
                lambda r: jloop.init_sim(spec, SEED, r))(jax.numpy.arange(R)))
            final = [np.asarray(x) for x in jax.tree.leaves(out)]
    return st.audit["digest_trail"], final


def port_trail(name, prof):
    with config.profile(prof):
        if name == "mm1":
            spec, params, k = mm1.build(record=False)[0], mm1.params(15), 16
        else:
            spec, params, k = uni_spec(usergen.torch_lib()), None, 8
        st = ex.run_experiment_stream(
            spec, params, R, wave_size=WAVE, chunk_steps=k, seed=SEED,
            audit=True, device="cpu", **({} if name == "mm1" else dict(
                summary_path=lambda s: sm.add(sm.empty(
                    s.clock.shape, "cpu", s.clock.dtype), s.clock))))
        final = None
        if name == "uni":
            out = loop.make_run(spec)(loop.init_sim(
                spec, SEED, torch.arange(R), device="cpu"))
            final = interop.sim_to_numpy(out)
    return st.audit["digest_trail"], final


@pytest.mark.parametrize("name,prof,classes", [
    ("mm1", "f64", ("i32", "i64")),
    ("uni", "f64", ("f32", "i32", "f64", "i64")),
    ("uni", "f32", ("f32", "i32", "f64", "i64")),
])
def test_trail_equals_reference(name, prof, classes):
    want, want_final = ref_trail(name, prof)
    got, got_final = port_trail(name, prof)
    assert [(r["wave"], r["chunk"]) for r in got] == [
        (r["wave"], r["chunk"]) for r in want]
    assert {r["wave"] for r in got} == {0, 1}
    for a, b in zip(got, want):
        assert {c: a[c] for c in classes} == {c: b[c] for c in classes}, (
            a["wave"], a["chunk"])
    if want_final is not None:
        # the float classes are compared: the states are bitwise equal
        for a, b in zip(got_final, want_final):
            assert a.dtype == b.dtype and np.array_equal(a, b)
