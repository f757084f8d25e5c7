"""Tutorial 3's jockeying park: the port's restatement against cimba_tpu.

``cimba_tpu_torch.examples.tut_3_balking`` and the reference's
``examples/tut_3_balking.py`` (two priority queues, a run-time queue id,
both readers, two timers a join kept or dropped by a select of the whole
Sim, ``timers_clear``, an interrupt of a pid decoded from a ticket,
``pert`` and ``lognormal`` draws) through ``jax.jit(jax.vmap(make_run))``
and the port's plain engine on the CPU (8 lanes, seed 11) to the
tutorial's horizon t=400, which every lane reaches its end well before:
leaf for leaf with ``interop.diff_leaves``, integers exact, floats within
1e-9 of each leaf's scale.  Then the tutorial's own gates, a state
carried across mid-run, and the generated kernel's header for the spec.
The f32 profile is in ``test_torch_tut3_f32.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.core import loop as jloop
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import kernel_run
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.examples import tut_3_balking as t3
from examples import tut_3_balking as j3

torch.set_num_threads(1)

RTOL = {"f64": 1e-9, "f32": 2e-5}
LANES, SEED, T_MID = 8, 11, 6.0


@functools.lru_cache(maxsize=None)
def ref(prof):
    """The reference's initial state and its compiled run to T_END."""
    with jconfig.profile(prof):
        spec = j3.build()
        js = jax.jit(jax.vmap(lambda r: jloop.init_sim(
            spec, SEED, r)))(jnp.arange(LANES))
        run = jax.jit(jax.vmap(jloop.make_run(spec, t_end=t3.T_END)))
        return js, run, run(js)


def check_tutorial_gates(out):
    """The reference's: no failed lane, the visitors' rides are the
    servers' count; and every visitor that left made N_VISITS tries,
    each a ride, a balk or a renege."""
    assert int(out.err.abs().sum()) == 0
    li = out.procs.locals_i[:, :t3.N_VISITORS]
    rides = li[:, :, t3.LI_VISITS]
    assert torch.equal(rides.sum(dim=1), out.user["served"])
    assert int(rides.sum()) > 0
    tries = rides + li[:, :, t3.LI_BALKED] + li[:, :, t3.LI_RENEGED]
    gone = out.procs.status[:, :t3.N_VISITORS] == 2
    assert bool((tries[gone] == t3.N_VISITS).all())


def check_matches_reference(prof):
    js, _, jout = ref(prof)
    with tconfig.profile(prof):
        spec = t3.build()
        ts = tloop.init_sim(spec, SEED, torch.arange(LANES), t3.params(),
                            device="cpu")
        tout = tloop.make_run(spec, t_end=t3.T_END)(ts)
    assert [x.dtype for x in jax.tree.leaves(js)] == [
        x.dtype for x in interop.sim_to_numpy(ts)]
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []
    check_tutorial_gates(tout)
    # the run took every verb: reneges, jockeys (new tickets neither a ride
    # nor a renege) and the servers' interrupts
    li = tout.procs.locals_i[:, :t3.N_VISITORS]
    assert int(li[:, :, t3.LI_RENEGED].sum()) > 0
    assert int((li[:, :, t3.LI_TICKET] - li[:, :, t3.LI_VISITS]
                - li[:, :, t3.LI_RENEGED]).sum()) > 0
    return tout


def test_matches_reference():
    check_matches_reference("f64")


def test_carried_state_finishes_as_reference():
    """The port's state at T_MID (visitors queued, timers pending, the
    servers part way), carried into the reference by
    ``interop.sim_to_numpy`` and run on by it to T_END: the port's own
    run from that state, leaf for leaf."""
    _, run, _ = ref("f64")
    with tconfig.profile("f64"):
        spec = t3.build()
        ts = tloop.init_sim(spec, SEED, torch.arange(LANES), device="cpu")
        mid = tloop.make_run(spec, t_end=T_MID)(ts)
        assert bool(mid.pqueues.live.any())
        assert bool(torch.isfinite(mid.events.time).any())
        tout = tloop.make_run(spec, t_end=t3.T_END)(mid)
    jmid = jax.tree.unflatten(jax.tree.structure(ref("f64")[0]),
                              [jnp.asarray(x) for x in
                               interop.sim_to_numpy(mid)])
    jout = run(jmid)
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL["f64"]) == []


def test_generated_kernel_header():
    """The spec takes the generated family: its header has the priority
    queues' rules and readers, the timers, the interrupt, and the two
    gates the selects lower to; its leaf table the queues' slots."""
    with tconfig.profile("f64"):
        spec = t3.build()
        s = tloop.init_sim(spec, SEED, torch.arange(2), device="cpu")
        lay, fn, table = kernel_run.kernel_for(spec, s)
    assert fn is kernel_run.gen_chunk
    h = lay["header"]
    for piece in ("NPQ = 2, PQW = 64", "pq_length<0>(s, w)",
                  "pq_position<1>(s, w,", "timer_add(s, w,",
                  "timers_clear(s, w,", "interrupt(s, w,", "pert<R>(Draws<S>",
                  "rint(", "if (!v", "WSIG = true"):
        assert piece in h, piece
    names = [n for n, _, _ in table]
    assert names[names.index("pqueues.items"):][:5] == [
        "pqueues.items", "pqueues.prio", "pqueues.seq", "pqueues.live",
        "pqueues.next_seq"]
    assert np.prod(dict((n, d) for n, _, d in table)["pqueues.live"]) == 128
