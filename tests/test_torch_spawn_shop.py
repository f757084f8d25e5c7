"""The spawn shop: the port's restatement against cimba_tpu.

``cimba_tpu_torch.examples.spawn_shop`` and the reference's
``examples/spawn_shop.py`` (a door spawning one shopper process per
arrival from a pool of 16 rows, a clerk, recycled rows, ``api.stop``
once 200 are served) through ``jax.jit(jax.vmap(make_run))`` and the
port's plain engine on the CPU (8 lanes, seed 42) to the end: leaf for
leaf with ``interop.diff_leaves``, integers exact, floats within 1e-9
of each leaf's scale.  Then the example's gates, a state carried into
the reference mid-run, and the generated kernel's header for the spec
(17 processes, the pool's range, dynamic shared memory).  The f32
profile is in ``test_torch_spawn_shop_f32.py``.
"""

import functools

import jax
import jax.numpy as jnp
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.core import loop as jloop
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import kernel_run
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.core import process as pr
from cimba_tpu_torch.examples import spawn_shop as ss
from examples import spawn_shop as jss

torch.set_num_threads(1)

RTOL = {"f64": 1e-9, "f32": 2e-5}
LANES, T_MID = 8, 60.0


@functools.lru_cache(maxsize=None)
def ref(prof):
    """The reference's initial state, its compiled run and its end."""
    with jconfig.profile(prof):
        spec = jss.build()
        js = jax.jit(jax.vmap(lambda r: jloop.init_sim(
            spec, ss.SEED, r)))(jnp.arange(LANES))
        run = jax.jit(jax.vmap(jloop.make_run(spec)))
        return js, run, run(js)


@functools.lru_cache(maxsize=None)
def port(prof):
    """The port's initial state, its state at T_MID and its end (the run
    to T_MID continued: truncation is exact)."""
    with tconfig.profile(prof):
        spec = ss.build()
        ts = tloop.init_sim(spec, ss.SEED, torch.arange(LANES),
                            device="cpu")
        mid = tloop.make_run(spec, t_end=T_MID)(ts)
        return ts, mid, tloop.make_run(spec)(mid)


def check_gates(out):
    """The example's gates, and the cell's: the clerk free or held by a
    RUNNING shopper, the mean time in the shop in (0, 20)."""
    ss.check_gates(out)
    holder = out.resources.holder[:, 0]
    held = holder >= 0
    st = out.procs.status.gather(1, holder.clamp(min=0).long()[:, None])[:, 0]
    assert bool((st[held] == pr.RUNNING).all())
    wait = ss.mean_wait(out)
    assert bool(((wait > 0) & (wait < 20)).all())


def check_matches_reference(prof):
    js, _, jout = ref(prof)
    ts, _, tout = port(prof)
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []
    check_gates(tout)
    # rows were recycled: more shoppers served than the pool has rows
    assert bool((tout.user["served"] > ss.N_SHOPPERS).all())
    return tout


def test_matches_reference():
    check_matches_reference("f64")


def test_carried_state_finishes_as_reference():
    """The port's state at T_MID (shoppers in the shop, some rows
    finished, some CREATED), carried into the reference by
    ``interop.sim_to_numpy`` and run on by it: the port's own run from
    that state, leaf for leaf."""
    _, run, _ = ref("f64")
    _, mid, tout = port("f64")
    st = mid.procs.status[:, 1:]
    assert bool((st == pr.RUNNING).any()) and bool((st == pr.FINISHED).any())
    assert bool((mid.user["served"] < ss.N_SERVED).all())
    jmid = jax.tree.unflatten(jax.tree.structure(ref("f64")[0]),
                              [jnp.asarray(x) for x in
                               interop.sim_to_numpy(mid)])
    assert interop.diff_leaves(jax.tree.leaves(run(jmid)),
                               interop.sim_to_numpy(tout), RTOL["f64"]) == []


def test_reference_state_with_created_rows_maps_leaf_for_leaf():
    """A reference Sim with CREATED rows (its initial state) goes into the
    port by ``interop.sim_from_numpy`` leaf for leaf, and the port runs
    it to the reference's end."""
    js, _, jout = ref("f64")
    with tconfig.profile("f64"):
        spec = ss.build()
        ts = interop.sim_from_numpy([jax.device_get(x) for x in
                                     jax.tree.leaves(js)], spec,
                                    device="cpu")
        assert bool((ts.procs.status[:, 1:] == pr.CREATED).all())
        tout = tloop.make_run(spec)(ts)
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL["f64"]) == []


def test_generated_kernel_header():
    """The spec takes the generated family: 17 processes, the pool's
    range as constexprs, the spawn rule with its pid kept, the clerk's
    verbs, the wakes and words in shared columns, dynamic shared
    memory."""
    with tconfig.profile("f64"):
        spec = ss.build()
        s = tloop.init_sim(spec, ss.SEED, torch.arange(2), device="cpu")
        lay, fn, table = kernel_run.kernel_for(spec, s)
    assert fn is kernel_run.gen_chunk
    h = lay["header"]
    for piece in ("NP = 17,", "type 0 'shopper' pids [1, 17)",
                  "N_SPAWN = 1;", "spawn_first(int i) { return (i == 0 ? 1",
                  "spawn_count(int i) { return (i == 0 ? 16",
                  "const int32_t h0 = spawn_pool<0>(s, w, s.clock, "
                  "int32_t(0));", "NR = 1,",
                  "DYN = true, BIG = true, GBIG = false;",
                  "(17 > 10 processes)", "THREADS = 32,"):
        assert piece in h, piece
