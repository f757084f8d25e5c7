"""The generated chunk kernel with a per-lane horizon, built with g++ on
the CPU (``tools/gxx_shim.py``), against the plain engine; and the leaf
count the kernel's pointer array takes.

A user spec of the generated family (``usergen.build(5, lib,
timers=True)``) runs 16 lanes under a ``t_stop`` column of ``+inf``, 4,
9 and ``-inf`` in chunks of 16 events, each chunk held against
``loop.make_run(spec, max_steps=16)`` from the same state (integers
exact, floats within 1e-9 in f64 and 2e-5 in f32 of each leaf's scale:
glibc's log1p is not torch's to the last place), to the end; one more
launch of the finished Sim changes no leaf.  ``usergen.wait_event_spec``
runs a lane whose tables a cancel drained while its processes wait on
events, under a ``-inf`` horizon: the kernel, as the engine, steps it
once to wake them with CANCELLED.  A Sim of 128 leaves fits the pointer
array: the kernel built for it runs as the plain engine does; its
horizon leaf would be the 129th, which a launch refuses.  Every test but
the last skips where there is no ``g++``; torch runs on one thread.
"""

import pytest
import torch

from cimba_tpu_torch import config, interop, tree
from cimba_tpu_torch.core import emit, kernel_run, loop
from cimba_tpu_torch.core import process as cmd
from cimba_tpu_torch.core.model import Model
from cimba_tpu_torch.tools import gxx_shim, usergen

torch.set_num_threads(1)

RTOL = {"f64": 1e-9, "f32": 2e-5}
INF = float("inf")
LANES = 16


def _col(n):
    return torch.tensor([INF, 4.0, 9.0, -INF] * (n // 4))


def _clone(s):
    return tree.map(lambda x: x.clone(), s)


def _built(spec, s):
    if not gxx_shim.available():
        pytest.skip("no g++ on PATH: the host build of the chunk kernel "
                    "needs one")
    lay = kernel_run.generated_kernel_for(spec, s)[0]
    return lay, gxx_shim.load(gxx_shim.build(lay["header"]))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree.leaves(a),
                                                 tree.leaves(b)))


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_generated_kernel_mixed_horizon(prof):
    with config.profile(prof):
        spec = usergen.build(5, usergen.torch_lib(), timers=True)[0]
        s = loop.init_sim(spec, 11, torch.arange(LANES), t_stop=_col(LANES),
                          device="cpu")
        lay, lib = _built(spec, s)
        cond = loop.make_cond(spec)
        k = 0
        while bool(cond(s).any()):
            ker = gxx_shim.chunk(lib, _clone(s), lay, 16, None)
            pla = loop.make_run(spec, max_steps=16)(s)
            bad = interop.diff_leaves(interop.sim_to_numpy(pla),
                                      interop.sim_to_numpy(ker), RTOL[prof])
            assert bad == [], (prof, k, bad[:4])
            s, k = pla, k + 1
        assert k > 2
        # -inf lanes never ran; a launch after the end changes nothing
        assert bool((s.n_events[3::4] == 0).all())
        assert bool((s.n_events[0::4] > s.n_events[1::4]).all())
        again = gxx_shim.chunk(lib, _clone(s), lay, 16, None)
        assert _same(s, again)


def test_generated_kernel_wakes_stranded_waiter_on_dead_lane():
    spec = usergen.wait_event_spec(usergen.torch_lib())
    s = loop.init_sim(spec, 17, torch.arange(4), t_stop=INF, device="cpu")
    s = loop.make_run(spec, max_steps=7)(s)
    # lane 0: every table time at +inf (its waiters' handles dead), and
    # a -inf horizon
    s = s._replace(
        events=s.events._replace(time=s.events.time.clone()),
        wakes=s.wakes._replace(time=s.wakes.time.clone()),
        t_stop=s.t_stop.clone())
    s.events.time[0] = INF
    s.wakes.time[0] = INF
    s.t_stop[0] = -INF
    assert bool((s.procs.await_evt[0] >= 0).any())
    lay, lib = _built(spec, s)
    ker = gxx_shim.chunk(lib, _clone(s), lay, 16, None)
    pla = loop.make_run(spec, max_steps=16)(s)
    assert interop.diff_leaves(interop.sim_to_numpy(pla),
                               interop.sim_to_numpy(ker), 1e-9) == []
    woke = s.procs.await_evt[0] >= 0
    assert bool((ker.procs.await_evt[0][woke] == -1).all())
    assert not bool(loop.make_cond(spec)(ker)[0])


def _wide_spec(n_user):
    """hello's greeter with ``n_user`` integer user leaves."""
    m = Model("wide", event_cap=4, guard_cap=1)

    @m.user_state
    def user_init(params):
        return {f"u{i:03d}": torch.zeros((), dtype=torch.int32)
                for i in range(n_user)}

    @m.block
    def greet(sim, p, sig):
        return sim, cmd.select(sim.clock >= 3.0, cmd.exit_(),
                               cmd.hold(1.0, next_pc=greet.pc))

    m.process("greeter", entry=greet)
    return m.build()


def _at_the_limit():
    base = len(tree.leaves(loop.init_sim(_wide_spec(0), 1, torch.arange(1),
                                         device="cpu")))
    return _wide_spec(emit.MAX_LEAVES - base), base


def test_sim_at_the_leaf_limit_runs():
    spec = _at_the_limit()[0]
    s = loop.init_sim(spec, 3, torch.arange(4), device="cpu")
    assert len(tree.leaves(s)) == emit.MAX_LEAVES
    lay, lib = _built(spec, s)
    ker = gxx_shim.chunk(lib, _clone(s), lay, 16, None)
    pla = loop.make_run(spec, max_steps=16)(s)
    assert interop.diff_leaves(interop.sim_to_numpy(pla),
                               interop.sim_to_numpy(ker), 1e-9) == []
    assert bool((pla.n_events == 4).all())
    assert not bool(loop.make_cond(spec)(pla).any())


def test_horizon_leaf_counts_against_the_pointer_array():
    spec, base = _at_the_limit()
    s = loop.init_sim(spec, 1, torch.arange(2), device="cpu")
    assert len(tree.leaves(s)) == emit.MAX_LEAVES
    emit.emit(spec, s)  # at the limit: taken
    with_h = loop.init_sim(spec, 1, torch.arange(2), t_stop=5.0,
                           device="cpu")
    lay, _, table = kernel_run.generated_kernel_for(spec, with_h)
    assert lay is kernel_run.generated_kernel_for(spec, s)[0]
    with pytest.raises(ValueError, match="129 leaves"):
        kernel_run._check_leaves(tree.leaves(with_h), table, lay,
                                 with_h.clock.dtype, with_h.n_events.dtype,
                                 True)
    # one leaf fewer, the horizon fits; the instance is the one without it
    narrow = _wide_spec(emit.MAX_LEAVES - base - 1)
    s1 = loop.init_sim(narrow, 1, torch.arange(2), t_stop=5.0,
                       device="cpu")
    lay, _, table = kernel_run.generated_kernel_for(narrow, s1)
    assert lay is kernel_run.generated_kernel_for(
        narrow, s1._replace(t_stop=None))[0]
    assert len(table) + 1 == emit.MAX_LEAVES
    assert kernel_run._check_leaves(tree.leaves(s1), table, lay,
                                    s1.clock.dtype, s1.n_events.dtype,
                                    True) == 2
