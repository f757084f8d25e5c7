"""The logger in the port (``cimba_tpu_torch.utils.logger``): the cases of
``tests/test_logger_kernel.py`` on the generated chunk kernel's front
end and the g++ shim, and the lines against the reference's.

* A disabled level computes nothing: the generated ``Gen<R>`` header of
  a spec whose block calls ``logger.info`` (INFO off) is byte-identical
  to the header of the same spec without the call.
* An enabled info, warning or user level reached while a block is
  traced for the generated kernel raises at emit; the same model logs
  on the plain engine.
* ``error`` and ``fatal`` keep the failure flag, drop the line and warn
  when traced: ``tools/usergen.fail_spec`` (error, fatal and
  ``dbc.assert_always``) and the reference's one-block error model fail
  every lane, on the plain engine and on the generated instance built
  with g++ (``tools/gxx_shim``), leaf for leaf equal; ``fatal`` with its
  level off still fails the lane.
* The lines: a two-process model (info, warning with the replay key, a
  user bit; constant holds, so the clocks are exact in both packages)
  run on 3 lanes by the port's plain engine prints, for each lane, the
  lines the reference prints for that replication run alone, with the
  call-site tag masked (the two models sit at different lines), in the
  reference's order of dispatches; within one dispatch (one clock and
  process) the lines are compared as a set, because the reference's
  lines are unordered effects (``jax.debug.callback``) that XLA
  schedules as it likes (it prints the user line of ``other`` before
  its warning; the port prints them in program order).  The
  reference's vmapped run prints a line for every lane at every block
  of every chain (vmap turns its block switch into a select), so the
  per-lane runs are its lines of blocks that ran.
"""

import functools
import re
import types
import warnings

import jax
import pytest
import torch

import cimba_tpu.random as jcr
from cimba_tpu.core import api as japi
from cimba_tpu.core import cmd as jcmd
from cimba_tpu.core import loop as jloop
from cimba_tpu.core.model import Model as JModel
from cimba_tpu.utils import logger as jlogger
from cimba_tpu_torch import config, interop, tree
from cimba_tpu_torch.core import emit, kernel_run, loop
from cimba_tpu_torch.tools import gxx_shim, usergen
from cimba_tpu_torch.utils import logger

torch.set_num_threads(1)

TLIB = usergen.torch_lib()
JLIB = types.SimpleNamespace(Model=JModel, api=japi, cmd=jcmd, cr=jcr,
                             logger=jlogger)
LANES = 3
_SRC = re.compile(r" \S+\(\d+\) err=")
_AT = re.compile(r" t=(\S+) p=(\S+) ")


def dispatches(lines):
    """Consecutive lines of one clock and process, each group sorted."""
    out = []
    for line in lines:
        at = _AT.search(line).groups()
        if out and out[-1][0] == at:
            out[-1][1].append(line)
        else:
            out.append((at, [line]))
    return [(at, sorted(group)) for at, group in out]


@pytest.fixture(autouse=True)
def default_flags():
    yield
    logger.flags_off(logger.INFO | logger.USER)
    logger.flags_on(logger.FATAL | logger.ERROR | logger.WARNING)
    jlogger.flags_off(jlogger.INFO | jlogger.USER)


def logging_model(lib, call=True, use_error=False):
    """The reference's ``_build_logging_model``: one process counting to
    5, logging each tick (or failing with ``error``)."""
    api, cmd, cr = lib.api, lib.cmd, lib.cr
    m = lib.Model("logm", n_ilocals=1, event_cap=4)

    @m.block
    def work(sim, p, sig):
        n = api.local_i(sim, p, 0)
        if use_error:
            sim = lib.logger.error(sim, p, "boom n={0}", n)
        elif call:
            sim = lib.logger.info(sim, p, "tick {0}", n)
        sim = api.add_local_i(sim, p, 0, 1)
        fin = n >= 5
        sim2, t = api.draw(sim, cr.exponential, 1.0)
        return sim2, cmd.select(fin, cmd.exit_(),
                                cmd.hold(t, next_pc=work.pc))

    m.process("w", entry=work)
    return m.build()


def _start(spec, lanes=4):
    return loop.init_sim(spec, 3, torch.arange(lanes), device="cpu")


@pytest.mark.parametrize("prof", ["f32", "f64"])
def test_disabled_info_traces_to_nothing(prof):
    with config.profile(prof):
        with_call = logging_model(TLIB, call=True)
        without = logging_model(TLIB, call=False)
        a = emit.emit(with_call, _start(with_call))
        b = emit.emit(without, _start(without))
    assert a == b


@pytest.mark.parametrize("level", ["info", "warning", "user"])
def test_enabled_level_raises_at_emit(level):
    logger.flags_on(logger.INFO | logger.WARNING | logger.USER)
    lib = types.SimpleNamespace(**vars(TLIB))
    lib.logger = types.SimpleNamespace(info={
        "info": logger.info, "warning": logger.warning,
        "user": functools.partial(logger.user, logger.USER)}[level])
    spec = logging_model(lib)
    with pytest.raises(RuntimeError, match="CUDA chunk kernel"):
        kernel_run.generated_kernel_for(spec, _start(spec))


def test_enabled_info_still_logs_on_plain_engine(capsys):
    logger.flags_on(logger.INFO)
    spec = logging_model(TLIB)
    out = loop.make_run(spec)(_start(spec, 2))
    assert bool((out.err == 0).all())
    lines = capsys.readouterr().out.splitlines()
    # 6 ticks a lane (n = 0..5), each a line
    assert sum(line.startswith("[info] r=0 ") for line in lines) == 6
    assert sum(line.startswith("[info] r=1 ") for line in lines) == 6


@functools.lru_cache(maxsize=None)
def shim_built(name, prof):
    with config.profile(prof):
        spec = (usergen.fail_spec(TLIB) if name == "fail"
                else logging_model(TLIB, use_error=True))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            lay = kernel_run.generated_kernel_for(spec, _start(spec))[0]
    lib = gxx_shim.load(gxx_shim.build(lay["header"]))
    return spec, lay, lib, [str(w.message) for w in caught]


@pytest.mark.parametrize("prof", ["f64", "f32"])
@pytest.mark.parametrize("name", ["fail", "logm"])
def test_error_and_fatal_fail_every_lane(name, prof, capsys):
    if not gxx_shim.available():
        pytest.skip("no g++ on PATH: the host build of the chunk kernel "
                    "needs one")
    spec, lay, lib, caught = shim_built(name, prof)
    want = (["logger.error", "logger.fatal"] if name == "fail"
            else ["logger.error"])
    assert [w.split(" ")[0] for w in caught] == want
    assert all("failure flag is preserved" in w for w in caught)
    with config.profile(prof):
        s0 = loop.init_sim(spec, 5, torch.arange(16), device="cpu")
        plain = loop.make_run(spec)(s0)
        ker = tree.map(lambda x: x.clone(), s0)
        cond = loop.make_cond(spec)
        while bool(cond(ker).any()):
            gxx_shim.chunk(lib, ker, lay, 16)
    assert bool((plain.err == loop.ERR_USER).all())
    assert interop.diff_leaves(tree.leaves(plain), tree.leaves(ker),
                               1e-9 if prof == "f64" else 2e-5) == []
    out = capsys.readouterr().out
    if name == "fail":
        # the plain engine prints each failing lane's line with its key
        assert "[error]" in out and "[fatal]" in out
        assert "replay: key=0x" in out


def test_fatal_line_and_masked_level(capsys):
    lib = TLIB
    m = lib.Model("fatalm", n_ilocals=1, event_cap=4)

    @m.block
    def work(sim, p, sig):
        sim = logger.fatal(sim, p, "unrecoverable n={0}",
                           lib.api.local_i(sim, p, 0))
        return sim, lib.cmd.exit_()

    m.process("w", entry=work)
    spec = m.build()
    out = loop.make_run(spec)(_start(spec, 1))
    assert int(out.err[0]) != 0
    text = capsys.readouterr().out
    assert "[fatal]" in text and "replay: key=" in text
    logger.flags_off(logger.FATAL)
    out = loop.make_run(spec)(_start(spec, 1))
    assert int(out.err[0]) != 0  # silencing the level does not unfail
    assert capsys.readouterr().out == ""


def lines_model(lib):
    """Two processes with constant holds (exact clocks); info, warning
    (with the replay key) and a user bit, each counting its wakes."""
    api, cmd, cr = lib.api, lib.cmd, lib.cr
    m = lib.Model("logl", n_ilocals=1, event_cap=4)

    @m.block
    def work(sim, p, sig):
        n = api.local_i(sim, p, 0)
        sim = lib.logger.info(sim, p, "tick {0}", n)
        sim = api.add_local_i(sim, p, 0, 1)
        sim, _ = api.draw(sim, cr.exponential, 1.0)
        return sim, cmd.select(n >= 2, cmd.exit_(),
                               cmd.hold(0.75, next_pc=other.pc))

    @m.block
    def other(sim, p, sig):
        sim = lib.logger.warning(sim, p, "other {0} at {1}",
                                 api.local_i(sim, p, 0), api.clock(sim))
        sim = lib.logger.user(lib.logger.USER, sim, p, "u {0}", p)
        return sim, cmd.hold(0.5, next_pc=work.pc)

    m.process("w", entry=work)
    m.process("v", entry=other)
    return m.build()


@functools.lru_cache(maxsize=None)
def ref_lines():
    import io
    from contextlib import redirect_stdout

    jlogger.flags_on(jlogger.INFO | jlogger.USER)
    try:
        spec = lines_model(JLIB)
        run = jax.jit(jloop.make_run(spec))
        out = {}
        for r in range(LANES):
            buf = io.StringIO()
            with redirect_stdout(buf):
                jax.block_until_ready(run(jloop.init_sim(spec, 7, r)))
                jax.effects_barrier()
            out[r] = [_SRC.sub(" SRC err=", line)
                      for line in buf.getvalue().splitlines()]
    finally:
        jlogger.flags_off(jlogger.INFO | jlogger.USER)
    return out


def test_lines_equal_reference(capsys):
    want = ref_lines()
    logger.flags_on(logger.INFO | logger.USER)
    spec = lines_model(TLIB)
    loop.make_run(spec)(loop.init_sim(spec, 7, torch.arange(LANES),
                                      device="cpu"))
    lines = [_SRC.sub(" SRC err=", line)
             for line in capsys.readouterr().out.splitlines()]
    for r in range(LANES):
        mine = [line for line in lines if f"] r={r} " in line]
        assert len(mine) == len(want[r]) >= 6, r
        assert dispatches(mine) == dispatches(want[r]), r
    assert any("replay: key=0x" in line for line in lines)
    assert any(line.startswith("[u10] ") for line in lines)
