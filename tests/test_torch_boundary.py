"""K1's boundary protocol for any spec: the port against cimba_tpu.

A boundary block (``Model.boundary_block``) runs outside the chunk
kernel: a chunk freezes a lane whose next dispatch resumes a process at
one (``boundary_pending``), and between chunks the host applies one
ordinary engine step to exactly the frozen lanes (the reference's
``pallas_run._boundary_apply``; the port's ``kernel_run.
make_boundary_step``).  A boundary block reached mid-chain fails its
lane with ``ERR_BOUNDARY``.

On the CPU the port's kernel-path host loop (``kernel_run.
make_kernel_run``: chunks of the plain engine with ``defer_boundary``,
then the plain round) is held against ``loop.make_run`` and both
against the reference's XLA ``make_run`` on the same seeds, on
``usergen.build(seed, lib, boundary=True)`` (a calibrator whose hold
resumes into a boundary block that reads the queue's length and the
clock through ``tanh``, an op the kernel's tracer refuses): integers
exact, floats within 1e-9 (f64) or 2e-5 (f32) of each leaf's scale.
The reference's mid-chain spec (``usergen.midchain_spec``) fails every
lane under the defer and runs clean on the plain path, as the
reference's does.  The generated family takes such a spec (the block is
a stub in its header, never traced), ``core.fuse`` still refuses it,
and the stream, the sweep and an unfused ``Service`` run it, each equal
to its direct run.  A ``slow`` twin holds the mid-chain spec against the
reference's interpret-mode ``make_kernel_run``.  Torch runs on one
thread; the reference runs are shared (``functools.lru_cache``).
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
from cimba_tpu.stats import summary as jsm
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop, tree
from cimba_tpu_torch.core import emit, fuse, kernel_run
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.runner import experiment as tex
from cimba_tpu_torch.tools import usergen

torch.set_num_threads(1)

RTOL = {"f64": 1e-9, "f32": 2e-5}
LANES, SEED, T_END = 6, 2026, 24.0
#: the usergen seeds of the boundary family the file runs
SPECS = (2026, 3)

JLIB = types.SimpleNamespace(
    Model=JModel, api=japi, cmd=jcmd, cr=jcr,
    zeros_i=lambda: jnp.zeros((), jnp.int32),
    real=lambda v: jnp.asarray(v, jconfig.REAL), where=jnp.where,
    empty=jsm.empty, add=jsm.add, floor=jnp.floor,
    i32=lambda x: jnp.asarray(x).astype(jnp.int32),
    real_of=lambda x: jnp.asarray(x).astype(jconfig.REAL), tanh=jnp.tanh,
    select_sim=lambda pred, a, b: jax.tree.map(
        lambda x, y: jnp.where(pred, x, y), a, b))


def _spec(name, lib):
    if name == "midchain":
        return usergen.midchain_spec(lib)
    return usergen.build(name, lib, boundary=True)[0]


def _t_end(name):
    return None if name == "midchain" else T_END


@functools.lru_cache(maxsize=None)
def ref_run(name, prof):
    """The reference's init and XLA run (the marker ignored) of ``name``
    on LANES lanes."""
    with jconfig.profile(prof):
        spec = _spec(name, JLIB)
        js = jax.jit(jax.vmap(lambda r: jloop.init_sim(spec, SEED, r)))(
            jnp.arange(LANES))
        out = jax.jit(jax.vmap(jloop.make_run(spec, t_end=_t_end(name))))(
            js)
    return ([np.asarray(x) for x in jax.tree.leaves(js)],
            [np.asarray(x) for x in jax.tree.leaves(out)])


@functools.lru_cache(maxsize=None)
def port_runs(name, prof):
    """The port's init, ``make_run`` and kernel-path host loop (defer
    plus plain rounds) on the CPU, and the loop's rounds."""
    with tconfig.profile(prof):
        spec = _spec(name, usergen.torch_lib())
        s = tloop.init_sim(spec, SEED, torch.arange(LANES), device="cpu")
        plain = tloop.make_run(spec, t_end=_t_end(name))(s)
        run = kernel_run.make_kernel_run(spec, t_end=_t_end(name),
                                         chunk_steps=16)
        kern = run(s)
    return spec, s, plain, kern, run.boundary_rounds


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree.leaves(a),
                                                 tree.leaves(b)))


@pytest.mark.parametrize("prof", ["f64", "f32"])
@pytest.mark.parametrize("name", SPECS)
def test_boundary_spec_matches_reference(name, prof):
    jinit, jout = ref_run(name, prof)
    spec, s, plain, kern, rounds = port_runs(name, prof)
    assert interop.diff_leaves(jinit, interop.sim_to_numpy(s), 0.0) == []
    assert interop.diff_leaves(jout, interop.sim_to_numpy(plain),
                               RTOL[prof]) == []
    # the kernel path's host loop: frozen lanes, a plain round each
    assert _equal(kern, plain)
    # each lane's calibrations are rounds of the loop (a round steps the
    # lanes frozen by then, which may freeze in different chunks)
    cal = plain.user["cal_n"]
    assert int(cal.min()) >= 2 and rounds >= int(cal.max())
    assert int(plain.err.ne(0).sum()) == 0
    assert not bool(kern.boundary_pending.any())


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_midchain_entry_fails_every_lane_under_defer(prof):
    jinit, jout = ref_run("midchain", prof)
    spec, s, plain, kern, rounds = port_runs("midchain", prof)
    # the plain path runs it clean, as the reference's XLA path does
    assert interop.diff_leaves(jout, interop.sim_to_numpy(plain),
                               RTOL[prof]) == []
    assert int(plain.err.ne(0).sum()) == 0
    # the kernel path: the first round runs the block, whose hold resumes
    # into go, which jumps back into it mid-chain
    assert rounds == 1
    assert bool((kern.err == tloop.ERR_BOUNDARY).all())


def test_generated_family_takes_boundary_blocks_untraced():
    spec, s, _, _, _ = port_runs(SPECS[0], "f64")
    emit.check_spec(spec)  # no longer refused
    lay = kernel_run.generated_kernel_for(spec, s)[0]
    (pc,) = spec.boundary_pcs
    h = lay["header"]
    assert "static constexpr bool BOUNDARY = true;" in h
    assert f"boundary(int pc) {{ return pc == {pc}; }}" in h
    # the block is a stub: tanh, which the tracer refuses, never traced
    assert "tanh" not in h
    with pytest.raises(NotImplementedError, match="tanh"):
        from cimba_tpu_torch.core import trace
        trace.trace_block(spec, pc, s)
    assert pc not in emit.op_counts(spec, s)
    # a spec with none keeps the flag off
    other = usergen.build(1, usergen.torch_lib())[0]
    so = tloop.init_sim(other, 1, torch.arange(1), device="cpu")
    assert "BOUNDARY = false;" in kernel_run.generated_kernel_for(
        other, so)[0]["header"]


def test_fuse_refuses_boundary_blocks():
    spec = port_runs(SPECS[0], "f64")[0]
    with pytest.raises(fuse.FusionError, match="boundary"):
        fuse.fuse_specs([spec, spec])


def test_boundary_round_is_plain_step_on_frozen_lanes_only():
    """``make_boundary_step`` on CPU tensors: the frozen lanes take one
    step, the others keep every leaf, the flag is cleared."""
    spec, s, _, _, _ = port_runs(SPECS[0], "f64")
    with tconfig.profile("f64"):
        chunk = tloop.make_run(spec, t_end=T_END, max_steps=64,
                               defer_boundary=True)
        a = chunk(s)
        frozen = a.boundary_pending.clone()
        assert bool(frozen.any())
        b = kernel_run.make_boundary_step(spec)(a)
    assert not bool(b.boundary_pending.any())
    for x, y in zip(tree.leaves(a._replace(boundary_pending=None)),
                    tree.leaves(b._replace(boundary_pending=None))):
        assert torch.equal(x[~frozen], y[~frozen])
    assert bool((b.n_events[frozen] == a.n_events[frozen] + 1).all())


def _stream_direct(prof, **kw):
    with tconfig.profile(prof):
        spec = _spec(SPECS[0], usergen.torch_lib())
        return spec, tex.run_experiment_stream(
            spec, (), 8, wave_size=4, seed=SEED, t_end=T_END,
            chunk_steps=16, summary_path=lambda s: s.user["w"],
            device="cpu", **kw)


def test_stream_sweep_and_service_run_boundary_specs():
    from cimba_tpu_torch import serve, sweep

    spec, st = _stream_direct("f64")
    with tconfig.profile("f64"):
        direct = tex.run_experiment(spec, (), 8, seed=SEED, t_end=T_END,
                                    device="cpu")
    assert int(st.total_events) == int(direct.total_events)
    assert int(st.n_failed) == 0
    # the sweep: one cell of the spec, bitwise the direct stream
    g = sweep.SweepGrid({"k": (0,)}, lambda k: (), name="b")
    with tconfig.profile("f64"):
        sw = sweep.run_sweep(spec, g, reps_per_cell=8, seed=SEED,
                             cell_wave=4, max_wave=8, t_end=T_END,
                             chunk_steps=16,
                             summary_path=lambda s: s.user["w"],
                             device="cpu")
        row = sweep.round_seed(SEED, 0, 0)
        one = tex.run_experiment_stream(
            spec, (), 8, wave_size=4, seed=row, t_end=T_END,
            chunk_steps=16, summary_path=lambda s: s.user["w"],
            device="cpu")
    for x, y in zip(tree.leaves(sw.summaries), tree.leaves(one.summary)):
        assert torch.equal(x[0], y)
    # an unfused service: bitwise the direct stream
    with tconfig.profile("f64"):
        with serve.Service(max_wave=8, device="cpu") as svc:
            h = svc.submit(serve.Request(
                spec, (), 8, seed=SEED, t_end=T_END, chunk_steps=16,
                wave_size=4, summary_path=lambda s: s.user["w"]))
            got = h.result(timeout=120)
    assert int(got.total_events) == int(st.total_events)
    for x, y in zip(tree.leaves(got.summary), tree.leaves(st.summary)):
        assert torch.equal(x, y)


@pytest.mark.slow
@pytest.mark.parametrize("prof", ["f32"])
def test_midchain_matches_reference_interpret_kernel(prof):
    """The reference's interpret-mode kernel run of the mid-chain spec
    (its kernel takes the f32 profile only): every lane failed with
    ERR_BOUNDARY, as the port's kernel path."""
    from cimba_tpu.core import pallas_run as jpr

    with jconfig.profile(prof):
        spec = _spec("midchain", JLIB)
        js = jax.jit(jax.vmap(lambda r: jloop.init_sim(spec, SEED, r)))(
            jnp.arange(4))
        ker = jpr.make_kernel_run(spec, chunk_steps=16, interpret=True)(js)
    _, _, _, kern, _ = port_runs("midchain", prof)
    assert bool((np.asarray(ker.err) == jloop.ERR_BOUNDARY).all())
    assert bool((kern.err == tloop.ERR_BOUNDARY).all())
    # lane for lane, the clocks and counts at the failure
    assert np.array_equal(np.asarray(ker.n_events),
                          kern.n_events[:4].numpy())
