"""Lane refill in the port (``core.loop.make_refill``,
``make_lanes_live``) on the reference's tiny spec
(``tests/test_refill.py:52``: one process holding unit steps until its
clock passes 12), against the reference's ``make_refill``.

A wave of 8 lanes with the horizon column ``+inf``, 4, 9, ``-inf`` runs
two chunks of 3 events; the lanes that are no longer live, the ``-inf``
pad lanes and the short horizon's, take new replications, seeds and a
``+inf`` horizon; the wave runs to its end (by hand, and through
``drive_chunks``' boundary hook).  The same steps in the
reference give the same leaves, bit for bit (hold and exit only: no
libm).  Each refilled lane equals its solo run from ``init_sim``; the
lanes left alone keep every leaf, as a wave never refilled has them; a
``-inf`` lane that is not refilled keeps its initial state and is never
live.  A wave without the ``t_stop`` leaf raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cimba_tpu.core import api as japi
from cimba_tpu.core import cmd as jcmd
from cimba_tpu.core import loop as jloop
from cimba_tpu.core.model import Model as JModel
from cimba_tpu_torch import interop, tree
from cimba_tpu_torch.core import api as tapi
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.core import process as tcmd
from cimba_tpu_torch.core.model import Model as TModel

torch.set_num_threads(1)

INF = float("inf")
LANES, SEED = 8, 4
COL = np.array([INF, 4.0, 9.0, -INF] * 2)
NEW_REPS = np.arange(100, 100 + LANES)
NEW_SEEDS = np.arange(50, 50 + LANES, dtype=np.uint64)


def tiny(Model, api, cmd, t_stop=12.0):
    m = Model("tiny", event_cap=1, guard_cap=2)

    @m.block
    def work(sim, p, sig):
        done = api.clock(sim) > t_stop
        return sim, cmd.select(done, cmd.exit_(),
                               cmd.hold(1.0, next_pc=work.pc))

    m.process("w", entry=work)
    return m.build()


def _mask(live):
    """The lanes to refill: every lane not live after the first chunks
    but lane 7, a ``-inf`` pad lane left dead."""
    m = ~np.asarray(live)
    m[7] = False
    return m


@functools.lru_cache(maxsize=None)
def ref_wave():
    spec = tiny(JModel, japi, jcmd)
    s = jax.vmap(lambda r, t: jloop.init_sim(spec, SEED, r, None, t_stop=t))(
        jnp.arange(LANES), jnp.asarray(COL))
    chunk = jax.jit(jloop.make_chunk(spec, max_steps=3))
    for _ in range(2):
        s, _ = chunk(s)
    live = np.asarray(jax.jit(jloop.make_lanes_live(spec))(s))
    mask = _mask(live)
    s = jax.jit(jloop.make_refill(spec))(
        s, jnp.asarray(mask), jnp.asarray(NEW_REPS), jnp.asarray(NEW_SEEDS),
        jnp.full((LANES,), jnp.inf), jnp.zeros((LANES,)))
    s = jax.jit(jax.vmap(jloop.make_run(spec)))(s)
    return live, [np.asarray(x) for x in jax.tree.leaves(s)]


def port_spec():
    return tiny(TModel, tapi, tcmd)


def test_refill_matches_reference_and_solo_runs():
    spec = port_spec()
    s0 = tloop.init_sim(spec, SEED, torch.arange(LANES),
                        t_stop=torch.from_numpy(COL), device="cpu")
    chunk = tloop.make_chunk(spec, max_steps=3)
    s = s0
    for _ in range(2):
        s, _ = chunk(s)
    live = tloop.make_lanes_live(spec)(s)
    ref_live, ref_leaves = ref_wave()
    assert np.array_equal(live.numpy(), ref_live)
    assert not bool(live[3]) and not bool(live[1])  # -inf and t_stop 4
    mask = _mask(live.numpy())
    before = s
    s = tloop.make_refill(spec)(
        s, torch.from_numpy(mask), torch.from_numpy(NEW_REPS),
        NEW_SEEDS, torch.full((LANES,), INF), None)
    # the lanes left alone keep every leaf
    keep = torch.from_numpy(~mask)
    for x, y in zip(tree.leaves(s), tree.leaves(before)):
        assert torch.equal(x[keep], y[keep])
    out = tloop.make_run(spec)(s)
    assert interop.diff_leaves(ref_leaves, interop.sim_to_numpy(out),
                               0.0) == []
    for lane in np.nonzero(mask)[0]:
        solo = tloop.make_run(spec)(tloop.init_sim(
            spec, NEW_SEEDS[lane:lane + 1], torch.tensor([NEW_REPS[lane]]),
            t_stop=INF, device="cpu"))
        for x, y in zip(tree.leaves(out), tree.leaves(solo)):
            assert torch.equal(x[lane:lane + 1], y), lane
    # the lanes left alone end as in the wave never refilled
    whole = tloop.make_run(spec)(s0)
    for x, y in zip(tree.leaves(out), tree.leaves(whole)):
        assert torch.equal(x[keep], y[keep])
    # the same refill from drive_chunks' boundary hook, after chunk 2
    refill = tloop.make_refill(spec)

    def on_boundary(n, sims):
        if n == 2:
            return refill(sims, torch.from_numpy(mask),
                          torch.from_numpy(NEW_REPS), NEW_SEEDS,
                          torch.full((LANES,), INF), None)
        return None

    hooked = tloop.drive_chunks(chunk, s0, poll_every=3,
                                on_boundary=on_boundary)
    for x, y in zip(tree.leaves(hooked), tree.leaves(out)):
        assert torch.equal(x, y)


def test_pad_lanes_are_inert():
    spec = port_spec()
    s0 = tloop.init_sim(spec, SEED, torch.arange(LANES),
                        t_stop=torch.full((LANES,), -INF), device="cpu")
    live = tloop.make_lanes_live(spec)
    assert not bool(live(s0).any())
    out = tloop.make_chunked_run(spec, chunk_steps=3)(s0)
    for x, y in zip(tree.leaves(out), tree.leaves(s0)):
        assert torch.equal(x, y)
    assert int(out.n_events.sum()) == 0


def test_refill_needs_the_horizon_leaf():
    spec = port_spec()
    s = tloop.init_sim(spec, SEED, torch.arange(4), device="cpu")
    with pytest.raises(ValueError, match="no per-lane t_stop"):
        tloop.make_refill(spec)(s, torch.ones(4, dtype=torch.bool),
                                torch.arange(4), 1, torch.zeros(4), None)
