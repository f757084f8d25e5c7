"""Tutorial 2's cheese park: the port's restatement against cimba_tpu.

``cimba_tpu_torch.examples.tut_2_park`` and the reference's
``examples/tut_2_park.py`` (a pool of 20 units taken by polite
``pool_acquire`` calls and mugged by ``pool_preempt``, ``dice`` and
exponential draws, every animal's belief reconciled with its signals,
and a user event scheduled by ``api.schedule`` whose handler stops every
animal at t=50) through ``jax.jit(jax.vmap(make_run))`` and the port's
plain engine on the CPU (8 lanes, seed 7) to the end: the stops give the
cheese back and the event set drains.  Leaf for leaf with
``interop.diff_leaves``, integers exact, floats within 1e-9 of each
leaf's scale.  Then the tutorial's own gates, a state carried across
mid-run in both directions, and the generated kernel's header for the
spec.  The f32 profile is in ``test_torch_park2_f32.py``.
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
from cimba_tpu_torch.examples import tut_2_park as t2
from examples import tut_2_park as j2

torch.set_num_threads(1)

RTOL = {"f64": 1e-9, "f32": 2e-5}
LANES, T_MID = 8, 20.0


@functools.lru_cache(maxsize=None)
def ref(prof):
    """The reference's initial state, its compiled run and its end."""
    with jconfig.profile(prof):
        spec, _ = j2.build()
        js = jax.jit(jax.vmap(lambda r: jloop.init_sim(
            spec, t2.SEED, r)))(jnp.arange(LANES))
        run = jax.jit(jax.vmap(jloop.make_run(spec)))
        return js, run, run(js)


def check_matches_reference(prof):
    js, _, jout = ref(prof)
    with tconfig.profile(prof):
        spec, _ = t2.build()
        ts = tloop.init_sim(spec, t2.SEED, torch.arange(LANES), t2.params(),
                            device="cpu")
        tout = tloop.make_run(spec)(ts)
    assert [x.dtype for x in jax.tree.leaves(js)] == [
        x.dtype for x in interop.sim_to_numpy(ts)]
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []
    # the tutorial's gates: no failed lane, the holdings back, muggings
    assert t2.check_gates(tout) > 0
    # every animal was stopped by the end event (exit signal STOPPED);
    # the god exited at t=0
    n = t2.N_MICE + t2.N_RATS
    assert bool((tout.procs.status == 2).all())
    assert bool((tout.procs.exit_sig[:, :n] == -3).all())
    assert bool((tout.procs.exit_sig[:, n] == 0).all())
    assert bool((tout.clock == t2.T_END).all())
    return tout


def test_matches_reference():
    check_matches_reference("f64")


def test_carried_state_finishes_as_reference():
    """The port's state at T_MID (animals holding cheese, some pended on
    the pool, the end event in the table), carried into the reference by
    ``interop.sim_to_numpy`` and run on by it to the end: the port's own
    run from that state, leaf for leaf.  (The other direction, in f32,
    is in ``test_torch_park2_f32.py``.)"""
    js, run, jout = ref("f64")
    with tconfig.profile("f64"):
        spec, _ = t2.build()
        ts = tloop.init_sim(spec, t2.SEED, torch.arange(LANES), device="cpu")
        mid = tloop.make_run(spec, t_end=T_MID)(ts)
        assert bool((mid.pools.held > 0).any())
        assert bool(torch.isfinite(mid.events.time).any())
        tout = tloop.make_run(spec)(mid)
    jmid = jax.tree.unflatten(jax.tree.structure(js),
                              [jnp.asarray(x) for x in
                               interop.sim_to_numpy(mid)])
    assert interop.diff_leaves(jax.tree.leaves(run(jmid)),
                               interop.sim_to_numpy(tout), RTOL["f64"]) == []


def test_generated_kernel_header():
    """The spec takes the generated family: its header has the pool
    preempt's rule (MUG), the dice draw, the end event's insert, and the
    handler stopping the seven animals by compile-time pid."""
    with tconfig.profile("f64"):
        spec, _ = t2.build()
        s = tloop.init_sim(spec, t2.SEED, torch.arange(2), device="cpu")
        lay, fn, table = kernel_run.kernel_for(spec, s)
    assert fn is kernel_run.gen_chunk
    h = lay["header"]
    for piece in ("MUG = true", "NR = 0, NH = 1", "NK = 1",
                  "dice(b", "int64_t(1LL), int64_t(3LL)",
                  "schedule_event(s, w, double(0x1.9000000000000p+5), "
                  "int32_t(10), int32_t(2), int32_t(0), int32_t(0));",
                  "static void hdl0(S& s, const Where& w, int p, "
                  "int32_t sig)",
                  "if constexpr (K == 0) hdl0(s, w, p, sig);"):
        assert piece in h, piece
    for pid in range(t2.N_MICE + t2.N_RATS):
        assert f"stop_at<{pid}>(s, w);" in h
    assert f"stop_at<{t2.N_MICE + t2.N_RATS}>" not in h
