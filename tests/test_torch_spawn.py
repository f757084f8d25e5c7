"""Spawn pools: the port's ``process(start=False)``, ``init_sim`` and
``api.spawn`` against cimba_tpu on the CPU.

The reference's three cases (``tests/test_spawn.py``) restated in the
port and held against the reference's ``make_run`` through
``jax.jit(jax.vmap(...))``, leaf for leaf with ``interop.diff_leaves``
(integers exact, floats within 1e-9 of each leaf's scale in f64, 2e-5
in f32):

* the per-customer M/M/1 (an arrival spawns one customer process per
  arrival from a pool of 8 rows; 30 customers, so rows are recycled)
  completes, serves in birth order and sees fresh locals;
* a burst of four spawns into a pool of two reports pid -1 twice;
* the reference's kernel-path case (f32, seed 11, 8 lanes): the port's
  plain engine, the kernel's plain version, against the reference.

``init_sim`` of a spec with a pool: the pool's rows CREATED with NEVER
wakes, the started processes' seqs their ranks, ``events.next_seq``
their count; a spec whose processes all start keeps seqs ``0..P-1``.
"""

import functools

import jax
import jax.numpy as jnp
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.core import loop as jloop
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import api
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.core import process as cmd
from cimba_tpu_torch.core import process as pr
from cimba_tpu_torch.core.model import Model
from cimba_tpu_torch.tools import usergen
from test_spawn import N_CUSTOMERS, POOL
from test_spawn import _build as _jbuild

torch.set_num_threads(1)

RTOL = {"f64": 1e-9, "f32": 2e-5}
LANES = 8


def build():
    """tests/test_spawn.py's per-customer M/M/1, in the port (the card's
    tests and chip_smoke.py build it from usergen too)."""
    return usergen.spawn_mm1_spec(usergen.torch_lib())


def build_burst(lib):
    """tests/test_spawn.py's burst: four spawns into a pool of two, in
    either package (``lib``: its Model, api, cmd and int32 cast)."""
    m = lib.Model("burst", event_cap=16)

    @m.user_state
    def init(params):
        return {"misses": lib.i32(0), "got": lib.i32(0)}

    @m.block
    def burst(sim, p, sig):
        for _ in range(4):
            sim, pid = lib.api.spawn(sim, pool)
            miss = lib.cast(pid < 0)
            u = sim.user
            sim = lib.api.set_user(sim, {
                **u, "misses": u["misses"] + miss,
                "got": u["got"] + (1 - miss)})
        return sim, lib.cmd.exit_()

    @m.block
    def worker(sim, p, sig):
        return sim, lib.cmd.hold(50.0, next_pc=w_done.pc)

    @m.block
    def w_done(sim, p, sig):
        return sim, lib.cmd.exit_()

    m.process("burster", entry=burst, prio=0)
    pool = m.process("workers", entry=worker, count=2, start=False)
    return m.build()


def _jlib():
    from cimba_tpu.core import api as japi
    from cimba_tpu.core import cmd as jcmd
    from cimba_tpu.core.model import Model as JModel

    return type("L", (), dict(
        Model=JModel, api=japi, cmd=jcmd,
        i32=staticmethod(lambda v: jnp.asarray(v, jnp.int32)),
        cast=staticmethod(lambda b: b.astype(jnp.int32))))


def _tlib():
    return type("L", (), dict(
        Model=Model, api=api, cmd=cmd,
        i32=staticmethod(lambda v: torch.tensor(v, dtype=torch.int32)),
        cast=staticmethod(lambda b: b.to(torch.int32))))


@functools.lru_cache(maxsize=None)
def ref(which, prof, seed):
    """The reference's initial state and its run to the end."""
    with jconfig.profile(prof):
        spec = _jbuild() if which == "mm1" else build_burst(_jlib())
        js = jax.jit(jax.vmap(lambda r: jloop.init_sim(spec, seed, r)))(
            jnp.arange(LANES))
        return js, jax.jit(jax.vmap(jloop.make_run(spec)))(js)


def port(which, prof, seed):
    with tconfig.profile(prof):
        spec = build() if which == "mm1" else build_burst(_tlib())
        ts = tloop.init_sim(spec, seed, torch.arange(LANES), device="cpu")
        return spec, ts, tloop.make_run(spec)(ts)


def check(which, prof, seed):
    js, jout = ref(which, prof, seed)
    spec, ts, tout = port(which, prof, seed)
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []
    return spec, ts, tout


def test_spawn_per_customer_completes_and_recycles():
    spec, ts, out = check("mm1", "f64", 7)
    assert int(out.err.abs().sum()) == 0
    assert bool((out.user["done"] == N_CUSTOMERS).all())
    assert bool((out.user["spawned"] == N_CUSTOMERS).all())
    assert bool(out.user["order_ok"].all())
    assert bool((out.user["sum_t"] > 0.0).all())
    # 30 customers through at most 8 rows: the rows that ran are
    # FINISHED, fewer than 30 of them, so rows were recycled
    used = out.procs.status[:, 1:] != pr.CREATED
    assert bool((out.procs.status[:, 1:][used] == pr.FINISHED).all())
    assert bool((used.sum(dim=1) < N_CUSTOMERS).all())


def test_spawn_pool_exhaustion_reports_minus_one():
    _, _, out = check("burst", "f64", 1)
    assert int(out.err.abs().sum()) == 0
    assert bool((out.user["got"] == 2).all())
    assert bool((out.user["misses"] == 2).all())


def test_spawn_kernel_path_case_matches_reference():
    """The reference's kernel-path case (f32, seed 11): the plain engine,
    which the generated kernel is held against on the card."""
    _, _, out = check("mm1", "f32", 11)
    assert int(out.err.abs().sum()) == 0
    assert bool((out.user["done"] == N_CUSTOMERS).all())


def test_spawn_mm1_spec_keeps_the_reference_constants():
    """The port's per-customer M/M/1 (usergen.spawn_mm1_spec) has the
    reference's customers and pool rows: 9 processes, 8 of them a pool."""
    assert (usergen.SPAWN_MM1_CUSTOMERS, usergen.SPAWN_MM1_POOL) == (
        N_CUSTOMERS, POOL)
    spec = build()
    assert spec.n_procs == 1 + POOL
    assert [(t.first_pid, t.count) for t in spec.spawn_types] == [(1, POOL)]


def test_init_with_pool_rows():
    """The pool's rows CREATED, their wakes NEVER; the arrival's wake at
    t0 with seq 0; next_seq the one started process."""
    with tconfig.profile("f64"):
        spec = build()
        s = tloop.init_sim(spec, 7, torch.arange(3), t0=2.5, device="cpu")
    assert spec.proc_start.tolist() == [True] + [False] * POOL
    assert s.procs.status[:, 0].eq(pr.RUNNING).all()
    assert s.procs.status[:, 1:].eq(pr.CREATED).all()
    assert s.wakes.time[:, 0].eq(2.5).all()
    assert torch.isinf(s.wakes.time[:, 1:]).all()
    assert s.wakes.seq[:, 0].eq(0).all()
    assert s.events.next_seq.eq(1).all()


def test_init_seqs_are_ranks_and_all_started_unchanged():
    """Seqs are the started processes' ranks in pid order (a pool in the
    middle skips none); a spec whose processes all start keeps seqs
    0..P-1, next_seq P and every process RUNNING."""
    def blk(sim, p, sig):
        return sim, cmd.exit_()

    m = Model("ranks")
    b = m.block(blk)
    m.process("a", entry=b, count=2)
    m.process("pool", entry=b, count=3, start=False)
    m.process("c", entry=b, count=2)
    spec = m.build()
    s = tloop.init_sim(spec, 1, torch.arange(2), device="cpu")
    assert s.wakes.seq[0].tolist()[:2] == [0, 1]
    assert s.wakes.seq[0].tolist()[5:] == [2, 3]
    assert s.events.next_seq.tolist() == [4, 4]
    assert s.procs.status[0].tolist() == [1, 1, 0, 0, 0, 1, 1]

    m = Model("all")
    b = m.block(blk)
    m.process("a", entry=b, count=5)
    spec = m.build()
    s = tloop.init_sim(spec, 1, torch.arange(2), device="cpu")
    assert s.wakes.seq.tolist() == [list(range(5))] * 2
    assert s.events.next_seq.tolist() == [5, 5]
    assert s.procs.status.eq(pr.RUNNING).all()
    assert s.wakes.time.eq(0.0).all()
