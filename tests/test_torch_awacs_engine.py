"""The AWACS model through the port's engine and host loop, against
cimba_tpu's engine, and the boundary protocol (``defer_boundary``).

Same spec, seed and parameters through ``jax.jit(jax.vmap(make_run))``
and the port's ``make_run`` on the CPU, in both profiles and both
scorings.  Every integer and bool leaf (n_events, pcs, statuses, wake
seqs, RNG counters, dwell counts, ...) must be equal — event order
included.  Float leaves carry the math libraries' differences in cos,
sin, log1p and the NN's summation order: f64 within 1e-12 of each leaf's
scale, f32 within 16 ulp of it (measured: ~6e-15 and ~1e-7).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.core import loop as jloop
from cimba_tpu.models import awacs as jawacs
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop, tree
from cimba_tpu_torch.core import kernel_run
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.core import process as cmd
from cimba_tpu_torch.core.model import Model
from cimba_tpu_torch.models import awacs, mm1

RTOL = {"f64": 1e-12, "f32": 16 * 2.0**-23}


@pytest.mark.parametrize("scoring", ["nn", "threshold"])
@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_awacs_matches_reference(prof, scoring):
    lanes, n, t_end = 8, 16, 2.0
    with jconfig.profile(prof), tconfig.profile(prof):
        jspec, _ = jawacs.build(n, scoring=scoring)
        tspec, _ = awacs.build(n, scoring=scoring)
        js = jax.jit(jax.vmap(
            lambda r: jloop.init_sim(jspec, 2026, r, jawacs.params(t_end))
        ))(jnp.arange(lanes))
        jout = jax.jit(jax.vmap(jloop.make_run(jspec)))(js)
        ts = tloop.init_sim(tspec, 2026, torch.arange(lanes),
                            awacs.params(t_end), device="cpu")
        tout = tloop.make_run(tspec)(ts)
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []
    assert int(tout.err.abs().sum()) == 0 and bool(tout.done.all())
    assert bool((tout.user["dwells"] == 3).all())  # t = 0, 1, 2
    # the reference's batched Sim carries over and back
    back = interop.sim_from_numpy(jax.tree.leaves(jout), tspec,
                                  awacs.params(t_end), device="cpu")
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(back), 0.0) == []


@pytest.mark.parametrize("prof", ["f32", "f64"])
def test_host_loop_with_boundary_rounds_equals_plain_run(prof):
    """The port's twin of the reference's test_kernel_matches_xla_f32_awacs:
    the CPU host loop (plain chunk with the boundary defer, then a
    boundary step of the frozen lanes) equals the plain run leaf for
    leaf."""
    with tconfig.profile(prof):
        spec, _ = awacs.build(16)
        s0 = tloop.init_sim(spec, 2026, torch.arange(8), awacs.params(4.0),
                            device="cpu")
        run = kernel_run.make_kernel_run(spec, chunk_steps=16)
        nn_before = awacs.nn_forward.launches
        ker = run(s0)
        nn_launches = awacs.nn_forward.launches - nn_before
        pla = tloop.make_run(spec)(s0)
    assert interop.diff_leaves(tree.leaves(pla), tree.leaves(ker), 0.0) == []
    assert run.boundary_rounds >= 5  # every dwell, t = 0 .. 4
    assert run.launches == 0 and nn_launches == 0  # CPU: plain chunks
    assert int(ker.err.abs().sum()) == 0 and not bool(
        ker.boundary_pending.any())


def test_defer_freezes_where_the_sensor_is_next():
    """The first dispatch of every lane is the sensor (pid N, prio 1, all
    starts at t=0): the deferred chunk consumes nothing and flags every
    lane; the boundary step runs exactly that dispatch."""
    spec, _ = awacs.build(4)
    s0 = tloop.init_sim(spec, 5, torch.arange(3), awacs.params(3.0),
                        device="cpu")
    chunk = tloop.make_run(spec, max_steps=50, defer_boundary=True)
    s1 = chunk(s0)
    assert bool(s1.boundary_pending.all()) and int(s1.n_events.sum()) == 0
    assert interop.diff_leaves(tree.leaves(s0._replace(
        boundary_pending=s1.boundary_pending)), tree.leaves(s1), 0.0) == []
    assert not bool(tloop.make_cond(spec, defer_boundary=True)(s1).any())
    assert bool(tloop.make_cond(spec)(s1).all())
    s2 = kernel_run.make_boundary_step(spec)(s1)
    ref = tloop.make_step(spec)(s0)
    assert interop.diff_leaves(tree.leaves(ref), tree.leaves(s2), 0.0) == []
    assert bool((s2.user["dwells"] == 1).all())
    # the next deferred chunk runs the targets and stops at the next dwell
    s3 = chunk(s2)
    assert bool(s3.boundary_pending.all())
    assert bool((s3.user["dwells"] == 1).all())
    assert bool((s3.clock <= 1.0).all())


def _jumpy():
    m = Model("jumpy")

    @m.block
    def start(sim, p, sig):
        return sim, cmd.jump(next_pc=sensor_dwell.pc)

    @m.boundary_block
    def sensor_dwell(sim, p, sig):
        return sim, cmd.hold(1.0, next_pc=sensor_dwell.pc)

    m.process("p", entry=start)
    return m.build()


def test_chained_entry_into_boundary_block_fails_the_lane():
    spec = _jumpy()
    assert spec.boundary_pcs == (1,)
    s0 = tloop.init_sim(spec, 1, torch.arange(2), device="cpu")
    bad = tloop.make_run(spec, max_steps=3, defer_boundary=True)(s0)
    assert bad.err.tolist() == [tloop.ERR_BOUNDARY] * 2
    # the stub in its place exits the process
    assert bad.procs.status[:, 0].tolist() == [2, 2]
    ok = tloop.make_run(spec, max_steps=3)(s0)
    assert ok.err.tolist() == [0, 0] and ok.n_events.tolist() == [3, 3]


def test_kernels_refuse_other_specs():
    # another spec with a boundary block: no dwell kernel, but the
    # generated family takes it (the block a stub in its header), and the
    # host loop's deferred chunks fail the jump's mid-chain entry
    spec = _jumpy()
    run = kernel_run.make_kernel_run(spec, chunk_steps=4)
    s0 = tloop.init_sim(spec, 1, torch.arange(2), device="cpu")
    assert run(s0).err.tolist() == [tloop.ERR_BOUNDARY] * 2
    lay = kernel_run.generated_kernel_for(spec, s0)[0]
    assert "static constexpr bool BOUNDARY = true;" in lay["header"]
    aw, _ = awacs.build(8)
    mm, _ = mm1.build(record=False)
    with pytest.raises(NotImplementedError):
        kernel_run.awacs_layout(mm)
    with pytest.raises(NotImplementedError):
        kernel_run.queue_layout(aw)
    lay = kernel_run.awacs_layout(aw)
    assert (lay["P"], lay["X"], lay["E"]) == (9, 8, 8)
    s0 = tloop.init_sim(aw, 3, torch.arange(2), awacs.params(2.0),
                        device="cpu")
    assert len(tree.leaves(s0)) == len(kernel_run.AWACS_LEAVES)
    before = kernel_run.awacs_chunk.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel_run.awacs_chunk(s0, lay, 8)
    assert kernel_run.awacs_chunk.launches == before
