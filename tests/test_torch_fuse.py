"""Cross-spec wave fusion in the port (``cimba_tpu_torch.core.fuse`` and
``Service(fuse=True)``) against the reference's ``cimba_tpu.core.fuse``
and its own solo runs (``tests/test_fuse.py``'s cases).

* ``fuse_specs`` builds the reference's structure: bases, rebased
  ``proc_entry``, member 0's block functions verbatim, the merged name;
* the same ``FusionError`` taxonomy: spawn pools, boundary blocks, a shape
  mismatch, an empty member set;
* ``make_fused_init`` equals the reference's leaf for leaf on the same
  columns (spec ids, seeds, horizons), in both profiles;
* three distinct specs in one fused wave, each result bitwise its solo
  direct call, in both profiles; a third member spliced into a short
  member's lanes by the fused refill; ``get_fused`` caches one bundle an
  ordered member tuple, and ``fusion_order_key`` orders a member set
  alike whatever the arrival order;
* ``sweep.run_fused_sweeps`` bitwise its per-point direct ``run_sweep``
  twins.
"""

import functools
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.core import api as japi
from cimba_tpu.core import cmd as jcmd
from cimba_tpu.core import fuse as jfuse
from cimba_tpu.core.model import Model as JModel
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop, serve, sweep, tree
from cimba_tpu_torch.core import api, fuse
from cimba_tpu_torch.core import process as cmd
from cimba_tpu_torch.core.model import Model
from cimba_tpu_torch.obs import audit
from cimba_tpu_torch.runner import experiment as ex
from cimba_tpu_torch.serve import cache as pc
from cimba_tpu_torch.stats import summary as sm
from cimba_tpu_torch.tools import usergen

torch.set_num_threads(1)

T = 60
TLIB = types.SimpleNamespace(Model=Model, api=api, cmd=cmd)
JLIB = types.SimpleNamespace(Model=JModel, api=japi, cmd=jcmd)


def fz(lib, n=3, t_stop=12.0):
    return tuple(usergen.fuse_spec(lib, i, t_stop) for i in range(n))


def clock_path(sims):
    return sm.add(sm.empty(sims.clock.shape, sims.clock.device), sims.clock)


def req(spec, R, *, seed, t_end=None, **kw):
    return serve.Request(spec, (), R, seed=seed, t_end=t_end, wave_size=R,
                         chunk_steps=4, summary_path=clock_path,
                         label=spec.name, **kw)


def direct(spec, R, cache, *, seed, t_end=None):
    return ex.run_experiment_stream(spec, (), R, wave_size=R, chunk_steps=4,
                                    seed=seed, t_end=t_end,
                                    summary_path=clock_path,
                                    program_cache=cache, device="cpu")


class Gated(serve.Service):
    """The fused refill service with the pack and boundary gates."""

    def __init__(self, **kw):
        self.pack_gate = threading.Event()
        self.started = threading.Event()
        self.release = threading.Event()
        kw.setdefault("fuse", True)
        kw.setdefault("horizon_bucket", None)
        kw.setdefault("refill", True)
        kw.setdefault("refill_every", 1)
        kw.setdefault("device", "cpu")
        super().__init__(**kw)

    def _serve_refill_wave(self, lead):
        assert self.pack_gate.wait(T), "pack gate never opened"
        return super()._serve_refill_wave(lead)

    def _refill_boundary(self, wave, n, sims, final=False):
        self.started.set()
        assert self.release.wait(T), "boundary gate never opened"
        return super()._refill_boundary(wave, n, sims, final=final)


@pytest.fixture
def services():
    made = []
    yield made
    for s in made:
        s.pack_gate.set()
        s.release.set()
        s.shutdown(wait=False, timeout=T)


@pytest.fixture(scope="module")
def fz3():
    return fz(TLIB)


def test_fuse_specs_structure_equals_reference(fz3):
    a, b, c = fz3
    f = fuse.fuse_specs([a, b, c])
    jf = jfuse.fuse_specs(list(fz(JLIB)))
    assert f.n_members == jf.n_members == 3
    assert f.bases == jf.bases == (0, 1, 2)
    assert f.spec.name == jf.spec.name == "fused(fz0+fz1+fz2)"
    assert list(f.spec.blocks[:len(a.blocks)]) == list(a.blocks)
    assert len(f.spec.blocks) == len(jf.spec.blocks)
    for k, (s, base) in enumerate(zip((a, b, c), f.bases)):
        np.testing.assert_array_equal(np.asarray(f.rebased[k].proc_entry),
                                      np.asarray(jf.rebased[k].proc_entry))
        np.testing.assert_array_equal(np.asarray(f.rebased[k].proc_entry),
                                      np.asarray(s.proc_entry) + base)
        assert f.rebased[k].blocks == f.spec.blocks
    assert f.spec.boundary_pcs == ()
    solo = fuse.fuse_specs([a])
    assert list(solo.spec.blocks) == list(a.blocks) and solo.bases == (0,)


def spawn_pool_spec(lib):
    m = lib.Model("fz_pool", event_cap=1, guard_cap=2)

    @m.block
    def work(sim, p, sig):
        return sim, lib.cmd.select(lib.api.clock(sim) > 4.0,
                                   lib.cmd.exit_(),
                                   lib.cmd.hold(1.0, next_pc=work.pc))

    m.process("w", entry=work)
    m.process("pool", entry=work, start=False)
    return m.build()


def boundary_spec(lib):
    m = lib.Model("fz_bnd", event_cap=1, guard_cap=2)

    @m.boundary_block
    def phys(sim, p, sig):
        return sim, lib.cmd.hold(1.0, next_pc=work.pc)

    @m.block
    def work(sim, p, sig):
        return sim, lib.cmd.select(lib.api.clock(sim) > 4.0,
                                   lib.cmd.exit_(),
                                   lib.cmd.hold(1.0, next_pc=phys.pc))

    m.process("w", entry=work)
    return m.build()


def fat_spec(lib):
    m = lib.Model("fz_fat", event_cap=4, guard_cap=2)

    @m.block
    def work(sim, p, sig):
        return sim, lib.cmd.hold(1.0, next_pc=work.pc)

    m.process("w", entry=work)
    return m.build()


@pytest.mark.parametrize("lib,mod", [(TLIB, fuse), (JLIB, jfuse)],
                         ids=["port", "reference"])
def test_fusion_rejections(lib, mod):
    with pytest.raises(mod.FusionError, match="spawn pool"):
        mod.fusion_shape_key(spawn_pool_spec(lib))
    with pytest.raises(mod.FusionError, match="boundary_pcs"):
        mod.fusion_shape_key(boundary_spec(lib))
    with pytest.raises(mod.FusionError, match="shape-compatible"):
        mod.fuse_specs([usergen.fuse_spec(lib, 0), fat_spec(lib)])
    with pytest.raises(mod.FusionError, match="empty"):
        mod.fuse_specs([])
    assert issubclass(mod.FusionError, ValueError)


L = 8
SIDS = np.array([0, 1, 2, 0, 2, 1, 0, 1])
T_STOPS = np.array([np.inf, 5.0, 3.0, -np.inf, 7.5, np.inf, 9.0, 2.0])


@functools.lru_cache(maxsize=None)
def ref_fused_init(prof):
    with jconfig.profile(prof):
        jf = jfuse.fuse_specs(list(fz(JLIB)))
        s = jax.jit(jfuse.make_fused_init(jf))(
            jnp.arange(L), jnp.arange(40, 40 + L, dtype=jnp.uint64),
            jnp.asarray(T_STOPS, jconfig.TIME), jnp.asarray(SIDS, jnp.int32),
            jnp.zeros((L,)))
        return [np.asarray(x) for x in jax.tree.leaves(s)]


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_make_fused_init_equals_reference(prof):
    with tconfig.profile(prof):
        f = fuse.fuse_specs(list(fz(TLIB)))
        s = fuse.make_fused_init(f)(
            torch.arange(L), np.arange(40, 40 + L, dtype=np.uint64),
            torch.tensor(T_STOPS, dtype=tconfig.time()),
            torch.from_numpy(SIDS), None, device="cpu")
        assert interop.diff_leaves(ref_fused_init(prof),
                                   interop.sim_to_numpy(s), 0.0) == []
        # each lane is its member's own birth
        for k in range(3):
            solo = fuse.make_fused_init(fuse.fuse_specs([f.rebased[k]]))(
                torch.arange(L), np.arange(40, 40 + L, dtype=np.uint64),
                torch.tensor(T_STOPS, dtype=tconfig.time()),
                torch.zeros(L, dtype=torch.int32), None, device="cpu")
            lanes = torch.from_numpy(SIDS == k)
            for x, y in zip(tree.leaves(s), tree.leaves(solo)):
                assert torch.equal(x[lanes], y[lanes])


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_fused_wave_bitwise_vs_solo(prof, services):
    with tconfig.profile(prof):
        specs = fz(TLIB)
        cache = pc.ProgramCache(capacity=64)
        svc = Gated(max_wave=16, cache=cache, fuse_max_specs=3,
                    pad_waves=False)
        services.append(svc)
        hs = [svc.submit(req(s, 4, seed=11 + i))
              for i, s in enumerate(specs)]
        svc.pack_gate.set()
        svc.release.set()
        out = [h.result(T) for h in hs]
        st = svc.stats()
        fu = st["fusion"]
        assert fu["enabled"] and fu["fused_waves"] >= 1, fu
        assert fu["roster_sizes"] == [3], fu
        assert st["batch_occupancy"].get(3) == 1, st["batch_occupancy"]
        for i, s in enumerate(specs):
            assert audit.stream_result_digest(out[i]) == \
                audit.stream_result_digest(direct(s, 4, cache, seed=11 + i))


def test_fused_refill_cross_spec_splice(fz3, services):
    a, b, c = fz3
    cache = pc.ProgramCache(capacity=64)
    svc = Gated(max_wave=8, cache=cache, fuse_max_specs=3, pad_waves=False)
    services.append(svc)
    lead = svc.submit(req(a, 4, seed=1, t_end=10.0))
    short = svc.submit(req(b, 4, seed=2, t_end=3.0))
    # 4 + 4 lanes fill max_wave: the third boards through the splice
    queued = svc.submit(req(c, 4, seed=3, t_end=5.0))
    svc.pack_gate.set()
    assert svc.started.wait(T)
    svc.release.set()
    got = [lead.result(T), short.result(T), queued.result(T)]
    st = svc.stats()
    fu = st["fusion"]
    assert fu["fused_waves"] >= 1 and fu["fused_lanes"] >= 8, fu
    assert fu["roster_sizes"] == [3], fu
    assert st["refill"]["refill_admissions"] >= 1, st["refill"]
    assert st["refill"]["lanes_refilled"] >= 4, st["refill"]
    for res, (spec, seed, t_end) in zip(got, ((a, 1, 10.0), (b, 2, 3.0),
                                              (c, 3, 5.0))):
        assert audit.stream_result_digest(res) == audit.stream_result_digest(
            direct(spec, 4, cache, seed=seed, t_end=t_end)), spec.name


def test_get_fused_caches_bundle_and_order_key(fz3):
    a, b, c = fz3
    cache = pc.ProgramCache()
    f1 = pc.get_fused(cache, (a, b, c))
    assert pc.get_fused(cache, (a, b, c)) is f1
    assert pc.get_fused(cache, (b, a, c)) is not f1
    order = sorted((c, a, b), key=pc.fusion_order_key)
    assert order == sorted((b, c, a), key=pc.fusion_order_key)
    assert pc.fusion_order_key(a).startswith("s:")
    # a rebuilt twin orders the same: the key is by value
    assert pc.fusion_order_key(usergen.fuse_spec(TLIB, 0)) == \
        pc.fusion_order_key(a)


def sweepable(lib, name, bias):
    m = lib.Model(name, event_cap=1, guard_cap=2)

    @m.user_state
    def user_init(params):
        (step,) = params
        return {"step": step}

    @m.block
    def work(sim, p, sig):
        return sim, lib.cmd.hold(sim.user["step"] + bias, next_pc=work.pc)

    m.process("w", entry=work)
    return m.build()


def test_run_fused_sweeps_bitwise_vs_direct():
    points = []
    for name, bias in (("fsw_a", 0.25), ("fsw_b", 0.75)):
        grid = sweep.SweepGrid({"step": (0.5, 1.0)},
                               lambda step: (np.float64(step),), name=name)
        points.append((sweepable(TLIB, name, bias), grid))
    kw = dict(reps_per_cell=4, seed=3, t_end=10.0, chunk_steps=4,
              summary_path=clock_path, device="cpu")
    fused = sweep.run_fused_sweeps(points, max_wave=16, **kw)
    for (spec, grid), got in zip(points, fused):
        want = sweep.run_sweep(spec, grid, **kw)
        for x, y in zip(
                tree.leaves((got.summaries, torch.as_tensor(got.n_failed),
                             torch.as_tensor(got.total_events))),
                tree.leaves((want.summaries, torch.as_tensor(want.n_failed),
                             torch.as_tensor(want.total_events)))):
            assert torch.equal(x, y)
        assert got.occupancy["serve"]["lanes_dispatched"] > 0
