"""Per-lane horizons (``Sim.t_stop``): the port's engine against cimba_tpu.

The same inputs, made with numpy from a seed, go through the reference's
``jax.vmap(lambda r, t: init_sim(spec, s, r, p, t_stop=t))`` and
``jax.vmap(make_run(spec))`` and the port's ``init_sim(..., t_stop=)``
and ``make_run`` on the CPU, leaf for leaf: integers exact, floats
within 1e-9 (f64) or 2e-5 (f32) of each leaf's scale, the tolerances of
the other parity tests (libm's log1p is not XLA's to the last place).
The horizon column mixes ``+inf``, two finite horizons and ``-inf``
lane by lane, on mm1 (both profiles), on a user spec of the generated
family (``usergen.build(5, lib, timers=True)``, built from the same code
in either package) and on ``usergen.wait_event_spec`` with a stranded
event waiter on a ``-inf`` lane, which ``make_cond``'s clause
``(nxt <= lim) | (empty & ~out_of_work)`` keeps live for its CANCELLED
wake.  Then, in the port alone: ``t_stop=None`` carries no leaf, a
``+inf`` column runs as no horizon and a column of ``t_end`` as the
static ``t_end``, bit for bit, a ``-inf`` lane keeps its initial state,
and a seed column of one value gives that seed's streams.
"""

import functools
import types

import jax
import jax.numpy as jnp
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
from cimba_tpu.stats import summary as jsm
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop, tree
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.models import mm1 as tmm1
from cimba_tpu_torch.tools import usergen

torch.set_num_threads(1)

RTOL = {"f64": 1e-9, "f32": 2e-5}
LANES, SEED, N = 8, 5, 30
#: the user spec's lanes: one a horizon group (its reference run is the
#: file's longest compile)
GEN_LANES = 4
INF = float("inf")

JLIB = types.SimpleNamespace(
    Model=JModel, api=japi, cmd=jcmd, cr=jcr,
    zeros_i=lambda: jnp.zeros((), jnp.int32),
    real=lambda v: jnp.asarray(v, jconfig.REAL), where=jnp.where,
    empty=jsm.empty, add=jsm.add, floor=jnp.floor,
    i32=lambda x: jnp.asarray(x).astype(jnp.int32),
    select_sim=lambda pred, a, b: jax.tree.map(
        lambda x, y: jnp.where(pred, x, y), a, b))


def column(lanes, finite=(4.0, 12.0)):
    """``+inf``, two finite horizons and ``-inf``, lane r taking entry
    ``r % 4``, then shuffled by a seeded numpy generator."""
    base = np.array([INF, finite[0], finite[1], -INF])
    col = base[np.arange(lanes) % 4]
    return np.random.default_rng(17).permutation(col)


def _specs(name, lib):
    if name == "mm1":
        return (jmm1 if lib is JLIB else tmm1).build(record=False)[0]
    if name == "gen":
        return usergen.build(5, lib, timers=True)[0]
    return usergen.wait_event_spec(lib)


def _params(name, lib):
    return (jmm1 if lib is JLIB else tmm1).params(N) if name == "mm1" \
        else None


def _lanes(name):
    return GEN_LANES if name == "gen" else LANES


@functools.lru_cache(maxsize=None)
def ref_run(name, prof):
    """The reference's init and run of ``name`` under the column."""
    col = column(_lanes(name))
    with jconfig.profile(prof):
        spec = _specs(name, JLIB)
        p = _params(name, JLIB)
        js = jax.jit(jax.vmap(lambda r, t: jloop.init_sim(
            spec, SEED, r, p, t_stop=t)))(jnp.arange(_lanes(name)),
                                          jnp.asarray(col))
        out = jax.jit(jax.vmap(jloop.make_run(spec)))(js)
    return ([np.asarray(x) for x in jax.tree.leaves(js)],
            [np.asarray(x) for x in jax.tree.leaves(out)])


def port_run(name, prof, col=None, t_end=None, seed=SEED):
    with tconfig.profile(prof):
        spec = _specs(name, usergen.torch_lib())
        s = tloop.init_sim(spec, seed, torch.arange(_lanes(name)),
                           _params(name, usergen.torch_lib()),
                           t_stop=None if col is None
                           else torch.from_numpy(col), device="cpu")
        return s, tloop.make_run(spec, t_end=t_end)(s)


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_mm1_horizon_column_matches_reference(prof):
    jinit, jout = ref_run("mm1", prof)
    s, out = port_run("mm1", prof, column(LANES))
    assert interop.diff_leaves(jinit, interop.sim_to_numpy(s), 0.0) == []
    assert interop.diff_leaves(jout, interop.sim_to_numpy(out),
                               RTOL[prof]) == []
    assert out.t_stop.dtype == {"f64": torch.float64,
                                "f32": torch.float32}[prof]
    col = column(LANES)
    # the -inf lanes never ran; the finite ones stopped at their horizon
    dead = torch.from_numpy(col == -INF)
    assert bool((out.n_events[dead] == 0).all())
    assert bool((out.n_events[~dead] > 0).all())


def test_generated_family_spec_horizon_matches_reference():
    jinit, jout = ref_run("gen", "f64")
    s, out = port_run("gen", "f64", column(GEN_LANES))
    assert interop.diff_leaves(jinit, interop.sim_to_numpy(s), 0.0) == []
    assert interop.diff_leaves(jout, interop.sim_to_numpy(out),
                               RTOL["f64"]) == []


def _stranded(leaves, spec_leaves_of):
    """The reference's leaf list with lane 0 emptied after its first
    events: every general-table time and every wake at +inf, so its
    event waiters' handles are dead and only the stranding term keeps it
    live; its horizon ``-inf``."""
    names = spec_leaves_of
    out = [np.array(x, copy=True) for x in leaves]
    out[names.index("events.time")][0] = INF
    out[names.index("wakes.time")][0] = INF
    out[names.index("t_stop")][0] = -INF
    return out


def test_stranded_waiter_on_dead_lane_wakes_cancelled():
    """A lane whose tables a cancel drained while a process waits on an
    event stays live under a ``-inf`` horizon for exactly the step that
    wakes the waiter with CANCELLED, in both packages."""
    with jconfig.profile("f64"):
        spec = _specs("waitev", JLIB)
        col = np.full(LANES, INF)
        js = jax.jit(jax.vmap(lambda r, t: jloop.init_sim(
            spec, 17, r, None, t_stop=t)))(jnp.arange(LANES),
                                           jnp.asarray(col))
        part = jax.jit(jax.vmap(jloop.make_run(spec, max_steps=7)))(js)
    tspec = _specs("waitev", usergen.torch_lib())
    tmpl = tloop.init_sim(tspec, 17, torch.arange(1), t_stop=0.0,
                          device="cpu")
    from cimba_tpu_torch.core import trace

    names = [n for n, _ in trace.named_leaves(tmpl)]
    planted = _stranded([np.asarray(x) for x in jax.tree.leaves(part)],
                        names)
    waiting = planted[names.index("procs.await_evt")][0] >= 0
    assert waiting.any()  # lane 0 has an event waiter to strand
    with jconfig.profile("f64"):
        jp = jax.tree.unflatten(jax.tree.structure(part),
                                [jnp.asarray(x) for x in planted])
        jlive = np.asarray(jax.vmap(jloop.make_cond(spec))(jp))
        jout = jax.jit(jax.vmap(jloop.make_run(spec)))(jp)
    tp = interop.sim_from_numpy(planted, tspec, device="cpu")
    cond = tloop.make_cond(tspec)
    assert bool(jlive[0]) and bool(cond(tp)[0])
    tout = tloop.make_run(tspec)(tp)
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), 1e-9) == []
    # one step: the waiters woke with CANCELLED (wakes due now), then the
    # horizon stops the lane
    assert int(tout.n_events[0]) == int(tp.n_events[0]) + 1 or bool(
        (tout.wakes.time[0][torch.from_numpy(waiting)] < INF).all())
    assert not bool(cond(tout)[0])


def test_no_leaf_inf_and_scalar_columns():
    """``t_stop=None`` carries no leaf; a ``+inf`` column runs as no
    horizon and a column of ``t_end`` as the static ``t_end``, leaf for
    leaf, bit for bit; a ``-inf`` lane keeps its initial state."""
    s0, plain = port_run("mm1", "f64")
    assert s0.t_stop is None
    assert len(tree.leaves(s0)) + 1 == len(tree.leaves(
        port_run("mm1", "f64", np.full(LANES, INF))[0]))
    for col, t_end in ((np.full(LANES, INF), None),
                       (np.full(LANES, 12.0), 12.0)):
        _, with_leaf = port_run("mm1", "f64", col)
        _, static = port_run("mm1", "f64", t_end=t_end)
        assert interop.diff_leaves(
            interop.sim_to_numpy(static),
            interop.sim_to_numpy(with_leaf._replace(t_stop=None)),
            0.0) == []
    s, out = port_run("mm1", "f32", np.full(LANES, -INF))
    assert interop.diff_leaves(interop.sim_to_numpy(s),
                               interop.sim_to_numpy(out), 0.0) == []


def test_seed_column_gives_scalar_seed_streams():
    _, scalar = port_run("mm1", "f64", seed=SEED)
    seeds = np.full(LANES, SEED, dtype=np.uint64)
    _, col = port_run("mm1", "f64", seed=seeds)
    assert interop.diff_leaves(interop.sim_to_numpy(scalar),
                               interop.sim_to_numpy(col), 0.0) == []
    # a seed past 2**63 travels as its 64 bits
    big = 2**64 - 3
    a = tloop.init_sim(_specs("mm1", usergen.torch_lib()), big,
                       torch.arange(4), tmm1.params(N), device="cpu")
    b = tloop.init_sim(_specs("mm1", usergen.torch_lib()),
                       np.full(4, big, dtype=np.uint64), torch.arange(4),
                       tmm1.params(N), device="cpu")
    assert torch.equal(a.rng.key0, b.rng.key0)
    assert torch.equal(a.rng.key1, b.rng.key1)
    with pytest.raises(ValueError, match="t_stop must be"):
        tloop.init_sim(_specs("mm1", usergen.torch_lib()), 1,
                       torch.arange(4), tmm1.params(N),
                       t_stop=torch.zeros(3), device="cpu")
