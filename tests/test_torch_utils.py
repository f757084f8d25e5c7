"""``cimba_tpu_torch.utils``: hwseed, the assertion tiers
(``tests/test_aux.py``'s cases on the port's plain engine) and the debug
strings, equal to the reference's on the same state.

The states for the strings are the port's (mm1 after 7 events, 3 lanes;
``usergen.wait_event_spec``, whose user event kind names its handler,
after 9 events with the flight recorder on, a ring of 4 that wraps),
carried into the reference's Sim (``interop.sim_to_numpy`` under the
reference's tree structure, from ``jax.eval_shape`` of its
``init_sim``); each lane's ``sim_str``, ``eventset_str``, ``procs_str``
and ``trace_str`` must equal the reference's text for that lane.
"""

import types

import jax
import jax.numpy as jnp
import pytest
import torch

import cimba_tpu.random as jcr
from cimba_tpu.core import api as japi
from cimba_tpu.core import cmd as jcmd
from cimba_tpu.core import loop as jloop
from cimba_tpu.core.model import Model as JModel
from cimba_tpu.models import mm1 as jmm1
from cimba_tpu.obs import trace as jtrace
from cimba_tpu.utils import debug as jdebug
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import api, loop
from cimba_tpu_torch.core import process as cmd
from cimba_tpu_torch.core.model import Model
from cimba_tpu_torch.models import mm1
from cimba_tpu_torch.obs import trace as ot
from cimba_tpu_torch.tools import usergen
from cimba_tpu_torch.utils import dbc, debug
from cimba_tpu_torch.utils import seed as hs

torch.set_num_threads(1)

JLIB = types.SimpleNamespace(Model=JModel, api=japi, cmd=jcmd, cr=jcr,
                             zeros_i=lambda: jnp.zeros((), jnp.int32))


def test_hwseed_entropy():
    seeds = {hs.hwseed() for _ in range(16)}
    assert len(seeds) == 16
    assert all(0 <= s < 2**64 for s in seeds)


def _tier_model(tier):
    m = Model("dbc", event_cap=8, guard_cap=2)

    @m.block
    def checked(sim, p, sig):
        sim = tier(sim, api.clock(sim) < -1.0)  # always false
        return sim, cmd.exit_()

    m.process("checked", entry=checked)
    return m.build()


def _err(spec):
    out = loop.make_run(spec)(loop.init_sim(spec, 0, torch.arange(2),
                                            device="cpu"))
    return out.err.tolist()


def test_assert_tiers():
    try:
        for tier, knob in ((dbc.assert_release, "nassert"),
                           (dbc.assert_debug, "ndebug")):
            spec = _tier_model(tier)
            dbc.configure(**{knob: False})
            assert _err(spec) == [loop.ERR_USER] * 2
            dbc.configure(**{knob: True})  # switched off: no failure
            assert _err(spec) == [0, 0]
        assert not dbc.debug_enabled()
        # the always tier ignores both switches
        assert _err(_tier_model(dbc.assert_always)) == [loop.ERR_USER] * 2
    finally:
        dbc.configure(ndebug=False, nassert=False)
    assert dbc.debug_enabled()


def _carry(sims, jinit):
    """The port's Sim as the reference's (its tree from eval_shape)."""
    shape = jax.eval_shape(jax.vmap(jinit), jnp.arange(sims.clock.shape[0]))
    return jax.tree.unflatten(jax.tree.structure(shape), [
        jnp.asarray(x) for x in interop.sim_to_numpy(sims)])


def _same_strings(sims, spec, jsims, jspec):
    for r in range(sims.clock.shape[0]):
        mine = debug.lane(sims, r)
        ref = jax.tree.map(lambda x: x[r], jsims)
        for name in ("sim_str", "eventset_str", "procs_str", "trace_str"):
            a = getattr(debug, name)(mine, spec)
            b = getattr(jdebug, name)(ref, jspec)
            assert a == b, (name, r, a, b)
        assert debug.procs_str(mine) == jdebug.procs_str(ref)


def test_debug_strings_equal_reference_mm1():
    spec, _ = mm1.build(record=False)
    s = loop.make_run(spec, max_steps=7)(loop.init_sim(
        spec, 4, torch.arange(3), mm1.params(50), device="cpu"))
    jspec, _ = jmm1.build(record=False)
    jsims = _carry(s, lambda r: jloop.init_sim(jspec, 4, r,
                                               jmm1.params(50)))
    _same_strings(s, spec, jsims, jspec)
    text = debug.sim_str(debug.lane(s, 0), spec)
    assert "event set" in text and "arrival" in text and "clock=" in text
    assert debug.trace_str(debug.lane(s, 0)) == "flight recorder: disabled"


def test_debug_strings_equal_reference_user_kinds_and_ring():
    ot.enable(4)
    jtrace.enable(4)
    try:
        spec = usergen.wait_event_spec(usergen.torch_lib())
        s = loop.make_run(spec, max_steps=9)(loop.init_sim(
            spec, 17, torch.arange(2), device="cpu"))
        jspec = usergen.wait_event_spec(JLIB)
        jsims = _carry(s, lambda r: jloop.init_sim(jspec, 17, r))
        _same_strings(s, spec, jsims, jspec)
        text = debug.trace_str(debug.lane(s, 1), spec)
        assert text.startswith("flight recorder: 4 recorded of 9")
    finally:
        ot.disable()
        jtrace.disable()
    assert debug.kind_name(2, spec) == "on_fire"
    assert debug.kind_name(7) == "user7"
    assert debug.subj_name(1, 0, spec) == spec.proc_names[1]
    assert debug.subj_name(5, 2, spec) == "5"


@pytest.mark.parametrize("kind", [0, 1])
def test_kind_names(kind):
    assert debug.kind_name(kind) == jdebug.kind_name(kind)
