"""The port's chunked run (core/kernel_run.py) on CPU tensors.

On the CPU ``make_kernel_run`` runs its plain chunk — the version the
CUDA kernel is held against on the card — so here it is held against
the reference's Pallas chunk kernel in interpret mode, under the f32
profile, as tests/test_pallas_run.py runs it.  Integer and bool leaves
must be equal; floats within 64 ulp of each leaf's scale (the log1p
differences of test_torch_random.py, accumulated).  The CUDA kernel
itself is tested on the card (test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.core import loop as jloop
from cimba_tpu.core import pallas_run
from cimba_tpu.models import mm1 as jmm1
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import kernel_run
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.core.model import Model
from cimba_tpu_torch.models import mm1 as tmm1


def test_plain_chunk_matches_pallas_interpret():
    lanes, n_objects = 16, 40
    with jconfig.profile("f32"), tconfig.profile("f32"):
        jspec, _ = jmm1.build(record=False)
        js = jax.jit(jax.vmap(
            lambda r: jloop.init_sim(jspec, 2026, r, jmm1.params(n_objects))
        ))(jnp.arange(lanes))
        jout = pallas_run.make_kernel_run(jspec, chunk_steps=64,
                                          interpret=True)(js)
        tspec, _ = tmm1.build(record=False)
        ts = tloop.init_sim(tspec, 2026, torch.arange(lanes),
                            tmm1.params(n_objects), device="cpu")
        run = kernel_run.make_kernel_run(tspec, chunk_steps=64)
        tout = run(ts)
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout),
                               64 * 2.0**-23) == []
    assert run.launches == 0  # the plain chunk launches nothing
    assert int(tout.err.abs().sum()) == 0 and bool(tout.done.all())


def test_chunk_size_does_not_change_results():
    spec, _ = tmm1.build(record=False)
    s0 = tloop.init_sim(spec, 3, torch.arange(8), tmm1.params(30),
                        device="cpu")
    a = kernel_run.make_kernel_run(spec, chunk_steps=7)(s0)
    b = tloop.make_run(spec)(s0)
    assert interop.diff_leaves(interop.sim_to_numpy(b),
                               interop.sim_to_numpy(a), 0.0) == []


def test_refuses_other_specs_and_cpu_launch():
    m = Model("other")

    @m.block
    def only(sim, p, sig):
        from cimba_tpu_torch.core import process as cmd

        return sim, cmd.exit_()

    m.process("p", entry=only)
    other = m.build()
    # no hand-written family restates it: its kernel is generated, from a
    # Sim of the spec
    with pytest.raises(NotImplementedError, match="M/M/1|hand-written"):
        kernel_run.queue_layout(other)
    with pytest.raises(NotImplementedError, match="traced from a Sim"):
        kernel_run.kernel_for(other)
    s_other = tloop.init_sim(other, 1, torch.arange(2), device="cpu")
    lay_o, kernel_o, _ = kernel_run.kernel_for(other, s_other)
    assert kernel_o is kernel_run.gen_chunk and lay_o["family"] == "gen"
    spec, _ = tmm1.build(record=False)
    lay = kernel_run.queue_layout(spec)
    s0 = tloop.init_sim(spec, 3, torch.arange(4), tmm1.params(10),
                        device="cpu")
    before = kernel_run.queue_chunk.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel_run.queue_chunk(s0, lay, 8)
    assert kernel_run.queue_chunk.launches == before


def test_max_chunks_exhaustion_raises():
    spec, _ = tmm1.build(record=False)
    s0 = tloop.init_sim(spec, 3, torch.arange(4), tmm1.params(50),
                        device="cpu")
    with pytest.raises(RuntimeError, match="still live"):
        kernel_run.make_kernel_run(spec, chunk_steps=4, max_chunks=2)(s0)


@pytest.mark.parametrize("prof", ["f64", "f32"])
@pytest.mark.parametrize("model", ["mm1", "mmc3"])
def test_recording_specs_match_plain_run(model, prof):
    """The host loop over recording specs (mm1.build(), mmc.build(3)) on
    CPU tensors equals the plain engine run to the end, leaf for leaf,
    the queue's length accumulator included."""
    from cimba_tpu_torch.models import mmc as tmmc

    with tconfig.profile(prof):
        spec, params = ((tmm1.build()[0], tmm1.params(30)) if model == "mm1"
                        else (tmmc.build(3)[0], tmmc.params(30, 2.5, 1.0)))
        s0 = tloop.init_sim(spec, 4, torch.arange(6), params, device="cpu")
        run = kernel_run.make_kernel_run(spec, chunk_steps=9)
        a = run(s0)
        b = tloop.make_run(spec)(s0)
    assert s0.queues.acc is not None
    assert interop.diff_leaves(interop.sim_to_numpy(b),
                               interop.sim_to_numpy(a), 0.0) == []
    assert run.launches == 0 and bool(a.done.all())


def test_queue_instances_and_layouts():
    """Every single-queue spec with an instance gets its layout and the
    leaf table of its Sim; a server count without one is refused with the
    counts that have one."""
    from cimba_tpu_torch import tree
    from cimba_tpu_torch.models import mmc as tmmc

    cases = [(tmm1.build(record=False)[0], 1, False),
             (tmm1.build()[0], 1, True)]
    cases += [(tmmc.build(c)[0], c, True) for c in (1, 2, 3, 4)]
    for spec, ns, rec in cases:
        lay, kernel, table = kernel_run.kernel_for(spec)
        assert kernel is kernel_run.queue_chunk
        assert (lay["NS"], lay["REC"], lay["P"]) == (ns, rec, 1 + ns)
        s = tloop.init_sim(spec, 1, torch.arange(3), tmm1.params(5),
                           device="cpu")
        assert kernel_run._check_leaves(tree.leaves(s), table, lay,
                                        s.clock.dtype,
                                        s.n_events.dtype) == 3
    for c in (5, 8):
        with pytest.raises(NotImplementedError, match="1 server, 1 server "
                           "recording, 2 servers recording"):
            kernel_run.make_kernel_run(tmmc.build(c)[0])


def test_mg1_and_tandem_layouts():
    """mg1.build() and tandem.build() get their own instances, layouts
    and leaf tables; mg1 (mm1's block names) is told from mm1 by its
    module and user keys; a spec of another shape is refused by the
    hand-written families (its kernel is the generated one)."""
    from cimba_tpu_torch import tree
    from cimba_tpu_torch.core import process as cmd
    from cimba_tpu_torch.models import mg1 as tmg1
    from cimba_tpu_torch.models import tandem as ttandem

    cases = [(tmg1.build()[0], tmg1.sweep_params(5, reps_per_cell=1)[0],
              ("mg1", 1, True), 1),
             (ttandem.build()[0], ttandem.sweep_grid(5).rows(1)[0],
              ("tandem", 2, True), 2)]
    for spec, params, shape, nq in cases:
        lay, kernel, table = kernel_run.kernel_for(spec)
        assert kernel is kernel_run.queue_chunk
        assert (lay["family"], lay["NS"], lay["REC"]) == shape
        assert kernel_run.queue_entry(lay)[0] == f"{shape[0]}_chunk"
        assert (lay["Q"], lay["G"], lay["P"]) == (nq, 2 * nq, 1 + shape[1])
        assert lay["caps"] == tuple(q.capacity for q in spec.queues)
        assert (lay["fronts"], lay["rears"]) == (
            tuple(range(0, 2 * nq, 2)), tuple(range(1, 2 * nq, 2)))
        s = tloop.init_sim(spec, 1, torch.arange(len(params[0])), params,
                           device="cpu")
        assert kernel_run._check_leaves(tree.leaves(s), table, lay,
                                        s.clock.dtype,
                                        s.n_events.dtype) == len(params[0])
        assert len(table) == len(tree.leaves(s))
    # mm1's block names under a module of another family's keys: refused
    m = Model("fake_mg1", n_ilocals=1, event_cap=1, guard_cap=4)
    m.objectqueue("buffer", capacity=8)
    blocks = []
    for name in tmm1.BLOCK_NAMES:
        def blk(sim, p, sig):
            return sim, cmd.exit_()
        blk.__name__ = name
        blocks.append(m.block(blk))
    m.process("arrival", entry=blocks[0])
    m.process("service", entry=blocks[3])
    fake = m.build()
    assert kernel_run._queue_family(fake) is None
    with pytest.raises(NotImplementedError, match="hand-written families"):
        kernel_run.queue_layout(fake)
