"""Seeded user specs of spawn pools past the generated kernel's old
process limit: the port's plain engine against cimba_tpu, and the
emitter's limits.

``cimba_tpu_torch.tools.usergen.build(seed, lib, spawn=True)`` writes a
random model of 11 to 32 processes: a door spawning a client process per
arrival from a pool (some spawns at a later ``at`` or another ``prio``)
into an overloaded desk (a binary resource), so the pool runs out and
``api.spawn`` returns -1, and finished rows are recycled; an optional
second pool of runners taking a unit of a resource pool; a burst that
exhausts the smaller pool at the start; a watcher waiting on a condition
that observes the desk.  Some seeds declare six spare resources first,
so the spec has 9 guards.  Each seed runs through
``jax.jit(jax.vmap(make_run))`` and the port's plain engine on the CPU
(4 lanes, seed 11) to the end, leaf for leaf (integers exact, floats
within 1e-9 of each leaf's scale in f64, 2e-5 in f32).  Seed 1 (19
processes, 9 guards) is here with the emitter's limits; seed 13 (32
processes) in ``test_torch_usergen_spawn_2.py``; seed 2 and seed 4 in
f32 in ``test_torch_usergen_spawn_3.py`` (one reference compile, ~15 s,
a case).
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
from cimba_tpu_torch.core import emit, kernel_run
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.core import process as pr
from cimba_tpu_torch.core.model import Model as TModel
from cimba_tpu_torch.tools import usergen

torch.set_num_threads(1)

LANES, RUN_SEED = 4, 11
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
    with jconfig.profile(prof):
        spec, _ = usergen.build(seed, JLIB, spawn=True)
        js = jax.jit(jax.vmap(lambda r: jloop.init_sim(
            spec, RUN_SEED, r)))(jnp.arange(LANES))
        return js, jax.jit(jax.vmap(jloop.make_run(spec)))(js)


def check_matches_reference(seed, prof="f64"):
    js, jout = ref_run(seed, prof)
    with tconfig.profile(prof):
        spec, n_items = usergen.build(seed, usergen.torch_lib(), spawn=True)
        ts = tloop.init_sim(spec, RUN_SEED, torch.arange(LANES),
                            device="cpu")
        out = tloop.make_run(spec)(ts)
    assert 11 <= spec.n_procs <= 32
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(out), RTOL[prof]) == []
    u = out.user
    assert int(out.err.abs().sum()) == 0
    assert bool((u["arrivals"] == n_items).all())
    # the burst exhausted a pool in every lane; more spawns than rows
    assert bool((u["missed"] > 0).all())
    rows = sum(pt.count for pt in spec.spawn_types)
    assert bool((u["spawned"] > rows).all())
    # every row that ran is FINISHED (recycled rows too), none RUNNING
    first = spec.spawn_types[0].first_pid
    st = out.procs.status[:, first:first + rows]
    assert bool(((st == pr.FINISHED) | (st == pr.CREATED)).all())
    return spec, out


def test_plain_engine_matches_reference():
    spec, out = check_matches_reference(1)
    assert spec.n_guards == 9 and spec.n_procs == 19
    assert int(out.user["seen"].sum()) > 0  # the observer's wakes


def test_check_spec_takes_32_processes_and_refuses_33():
    """32 processes pass check_spec; a 33rd is refused, naming the count
    and the limit."""
    spec, _ = usergen.build(13, usergen.torch_lib(), spawn=True)
    assert spec.n_procs == emit.MAX_PROCS == 32
    emit.check_spec(spec)
    m = TModel("spawn33")
    blk = m.block(lambda sim, p, sig: (sim, pr.exit_()))
    m.process("door", entry=blk)
    m.process("pool", entry=blk, count=32, start=False)
    with pytest.raises(NotImplementedError,
                       match=r"33 processes \(at most 32\)"):
        emit.check_spec(m.build())


@pytest.mark.parametrize("prof,per_lane", [("f64", 3168), ("f32", 2236)])
def test_emitted_block_and_shared_memory_for_32_processes(prof, per_lane):
    """The 32-process spec's lane takes ``per_lane`` bytes of shared
    columns (the wakes and words among them): 32 lanes a block, past the
    static 48 KB, so the columns take dynamic shared memory."""
    with tconfig.profile(prof):
        spec, _ = usergen.build(13, usergen.torch_lib(), spawn=True)
        s = tloop.init_sim(spec, RUN_SEED, torch.arange(1), device="cpu")
        lay, _, _ = kernel_run.kernel_for(spec, s)
    h = lay["header"]
    assert (f"// {per_lane} B of shared columns a lane, dynamic shared "
            "memory; wakes and words in shared columns (32 > 10 "
            "processes)") in h
    for piece in ("THREADS = 32,", "DYN = true, BIG = true,", "NP = 32,",
                  "TOOLKIT = true", "minb() { return 8; }"):
        assert piece in h, piece
    assert emit.SMEM < 32 * per_lane < emit.SMEM_DYN
