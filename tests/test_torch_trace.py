"""The tracer and the emitter of the generated K1 (``core/trace.py``,
``core/emit.py``), on the CPU.

* Each block's IR, replayed with torch (``trace.replay``) on a state part
  way through a run, equals the block itself bit for bit (every leaf and
  the command's fields, dtypes included) in both profiles, for the two
  user programs (the cookbook's balking M/M/1, the tutorial harbor), and
  for ``mm1``, ``mmc(3)``, ``tandem`` and ``jobshop``.
* A Python branch on a traced value raises, naming the block; so does an
  op the emitter does not know, and a sampler without a device
  counterpart; a spec with more guards than the kernel's packed word
  holds is refused before any tracing.
* The emitter's output is deterministic: two builds of one spec give the
  same header, and so the same hash (the library's directory).
* A user event handler traces as a block without a command and replays
  bit for bit, and so do the engine calls ``api.schedule``,
  ``api.stop_process`` and ``api.release`` (tutorial 2's park, a
  resource released under a select); a ``dice`` draw is one int64 draw
  node; a kept handle of a gated ``api.schedule`` is a ``TraceError``.
* ``api.spawn`` is an engine call whose pid is a ``callres`` node: a
  block that spawns (at a traced time and priority too) and uses the pid
  in arithmetic replays bit for bit and emits ``spawn_pool<T>``; a use of
  the pid of a spawn that a select keeps or drops is a ``TraceError``
  naming the block and the select's line.
"""

import pytest
import torch

import cimba_tpu_torch.random as cr
from cimba_tpu_torch import config
from cimba_tpu_torch.core import emit, kernel_run, loop, trace
from cimba_tpu_torch.core import process as cmd
from cimba_tpu_torch.core.model import Model
from cimba_tpu_torch.examples import cookbook_balking, tut_4_harbor
from cimba_tpu_torch.models import jobshop, mm1, mmc, tandem

torch.set_num_threads(1)

LANES = 12

SPECS = {
    "balking": (lambda: cookbook_balking.build()[0],
                lambda: cookbook_balking.params(40), 60),
    "harbor": (tut_4_harbor.build, tut_4_harbor.params, 40),
    "mm1": (lambda: mm1.build()[0], lambda: mm1.params(40), 40),
    "mmc3": (lambda: mmc.build(3)[0], lambda: mmc.params(40, 2.5, 1.0), 40),
    "tandem": (lambda: tandem.build()[0],
               lambda: tandem.sweep_grid(40).rows(2)[0], 40),
    "jobshop": (lambda: jobshop.build()[0], lambda: jobshop.params(20), 40),
}


@pytest.mark.parametrize("prof", ["f64", "f32"])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_replay_equals_block(name, prof):
    build, params, steps = SPECS[name]
    with config.profile(prof):
        spec = build()
        s = loop.init_sim(spec, 5, torch.arange(LANES), params(),
                          device="cpu")
        s = loop.make_run(spec, max_steps=steps)(s)
        p = torch.arange(LANES, dtype=torch.int32) % spec.n_procs
        sig = torch.zeros(LANES, dtype=torch.int32)
        for pc, blk in enumerate(spec.blocks):
            ir = trace.trace_block(spec, pc, s)
            a_sim, a_cmd = blk(s, p, sig)
            a_cmd = cmd.normalize(a_cmd, LANES, s.clock.device,
                                  s.clock.dtype)
            b_sim, b_cmd = trace.replay(spec, ir, s, p, sig)
            for (n, x), (_, y) in zip(trace.named_leaves(a_sim),
                                      trace.named_leaves(b_sim)):
                assert x.dtype == y.dtype and torch.equal(x, y), (pc, n)
            for x, y in zip(a_cmd, b_cmd):
                assert x.dtype == y.dtype and torch.equal(x, y), pc


def _one_block_spec(body):
    m = Model("probe", n_ilocals=1)

    @m.user_state
    def init(params):
        return {"x": torch.zeros((), dtype=torch.float64)}

    blk = m.block(body)
    m.process("p", entry=blk)
    spec = m.build()
    return spec, loop.init_sim(spec, 1, torch.arange(2), device="cpu")


def test_python_branch_on_traced_value_raises():
    def branchy(sim, p, sig):
        if sim.clock > 1.0:
            return sim, cmd.exit_()
        return sim, cmd.hold(1.0, next_pc=0)

    spec, s = _one_block_spec(branchy)
    with pytest.raises(trace.TraceError,
                       match="block 'branchy'.*branches in Python"):
        trace.trace_block(spec, 0, s)
    with pytest.raises(NotImplementedError, match="branchy"):
        kernel_run.generated_kernel_for(spec, s)


def test_item_on_traced_value_raises():
    def hosty(sim, p, sig):
        return sim, cmd.hold(float(sim.user["x"].item()), next_pc=0)

    spec, s = _one_block_spec(hosty)
    with pytest.raises(trace.TraceError, match="hosty.*branches in Python"):
        trace.trace_block(spec, 0, s)


def test_unknown_op_names_its_block():
    def tanhy(sim, p, sig):
        return sim, cmd.hold(torch.tanh(sim.clock) + 1.0, next_pc=0)

    spec, s = _one_block_spec(tanhy)
    with pytest.raises(NotImplementedError,
                       match=r"block 'tanhy'.*op tanh.*test_torch_trace"):
        trace.trace_block(spec, 0, s)


def test_sampler_without_device_counterpart_raises_at_emit():
    def weibully(sim, p, sig):
        sim, t = api_draw(sim, cr.weibull, 2.0, 1.0)
        return sim, cmd.hold(t, next_pc=0)

    from cimba_tpu_torch.core import api

    api_draw = api.draw
    spec, s = _one_block_spec(weibully)
    trace.trace_block(spec, 0, s)  # the tracer takes it: one draw node
    with pytest.raises(NotImplementedError,
                       match="weibully.*sampler .*weibull has no device"):
        emit.emit(spec, s)


def test_too_many_guards_refused_before_tracing():
    """A guard id past the packed word's 8 signed bits (127 guards, 0 to
    126) is refused before any tracing, naming the count."""
    m = Model("wide")
    for i in range(64):
        m.objectqueue(f"q{i}", capacity=2)

    @m.block
    def idle(sim, p, sig):
        return sim, cmd.exit_()

    m.process("p", entry=idle)
    spec = m.build()
    with pytest.raises(NotImplementedError, match=r"128 guards \(at most "
                                                  r"127\)"):
        kernel_run.make_kernel_run(spec)


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_emit_is_deterministic(prof):
    with config.profile(prof):
        heads = []
        for _ in range(2):
            spec = tut_4_harbor.build()
            s = loop.init_sim(spec, 4, torch.arange(3), None, device="cpu")
            heads.append(emit.emit(spec, s))
    assert heads[0] == heads[1]
    assert emit.header_hash(heads[0]) == emit.header_hash(heads[1])
    assert f"CIMBA_GEN_{prof.upper()}" in heads[0]


def _shared_block_spec(body, n_procs=4):
    """``n_procs`` processes sharing one block (a run-time pid)."""
    m = Model("shared", n_flocals=2)

    @m.user_state
    def init(params):
        return {"x": torch.zeros((), dtype=torch.float64)}

    blk = m.block(body)
    for k in range(n_procs):
        m.process(f"p{k}", entry=blk)
    spec = m.build()
    return spec, loop.init_sim(spec, 1, torch.arange(2), device="cpu")


def test_trace_records_each_pid_write_as_one_put():
    def writer(sim, p, sig):
        sim = api.set_local_f(sim, p, 1, sim.clock + 1.0)
        return sim, cmd.hold(1.0, next_pc=0)

    from cimba_tpu_torch.core import api

    spec, s = _shared_block_spec(writer)
    ir = trace.trace_block(spec, 0, s)
    assert len(ir.puts) == 1 and len(ir.puts[0]) == 4
    assert {ir.nodes[w].op for w in ir.puts[0]} == {"where"}


@pytest.mark.parametrize("n_procs", [2, 4, 7])
def test_op_counts_take_a_pid_write_as_one_store(n_procs):
    """The bound's count of a block: a write by a traced pid is one
    store whatever the process count (not its n_procs position tests and
    selects); a read by one is one load; a library function counts its
    weight, a division by a Python number one multiply."""
    from cimba_tpu_torch.core import api

    def body(sim, p, sig):
        x = api.local_f(sim, p, 0)  # the pid's cast to an index, a load
        y = torch.sin(x) / 3.0 + x / sim.clock  # sin, mul, div, add
        sim = api.set_local_f(sim, p, 1, y)  # one store
        return sim, cmd.hold(1.0, next_pc=0)

    spec, s = _shared_block_spec(body, n_procs)
    assert emit.op_counts(spec, s) == {0: 7}
    assert emit.op_counts(spec, s, {"sin": 20, "div": 8}) == {0: 7 + 19 + 7}


def _park3_state(prof, lanes=LANES):
    """Tutorial 3's park part way, with the lanes set up so that each of
    its three gates goes both ways: the first lanes' queues hold five
    ghost tickets each (a join there balks), a signal a lane cycles
    through served, renege, jockey and none, and the servers' tickets
    alternately live and stale."""
    from cimba_tpu_torch.examples import tut_3_balking as t3

    spec = t3.build()
    s = loop.init_sim(spec, 5, torch.arange(lanes), device="cpu")
    s = loop.make_run(spec, max_steps=30)(s)
    live = s.pqueues.live.clone()
    live[: lanes // 2, :, :5] = True
    s = s._replace(pqueues=s.pqueues._replace(live=live))
    tickets = (torch.arange(lanes) % t3.N_VISITORS).to(s.clock.dtype)
    gen = s.procs.locals_i[torch.arange(lanes),
                           torch.arange(lanes) % t3.N_VISITORS, t3.LI_TICKET]
    stale = (torch.arange(lanes) % 2).to(gen.dtype)
    got = s.procs.got.clone()
    got[:, t3.N_VISITORS:] = (tickets + (gen + stale).to(s.clock.dtype)
                              / 1024.0)[:, None]
    s = s._replace(procs=s.procs._replace(got=got))
    sigs = torch.tensor([t3.SIG_SERVED, t3.SIG_RENEGE, t3.SIG_JOCKEY, 0],
                        dtype=torch.int32)
    sig = sigs[torch.arange(lanes) % 4]
    return spec, s, sig


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_predicated_calls_replay_both_sides(prof):
    """Tutorial 3's three selects of the whole Sim (the join's two timers,
    the leave's timers_clear, the service's interrupt) lower to gated
    calls; the replay of each block equals the block bit for bit on
    lanes where its gate is open and where it is shut, for a visitor and
    a server pid."""
    with config.profile(prof):
        spec, s, sig = _park3_state(prof)
        gated = {}
        for pc, blk in enumerate(spec.blocks):
            ir = trace.trace_block(spec, pc, s)
            for e in ir.effects:
                if e[0] == "call" and len(e) > 4:
                    gated.setdefault(ir.name, []).append(e[1])
            for p0 in (0, 8):
                p = torch.full((LANES,), p0, dtype=torch.int32)
                a_sim, a_cmd = blk(s, p, sig)
                a_cmd = cmd.normalize(a_cmd, LANES, s.clock.device,
                                      s.clock.dtype)
                b_sim, b_cmd = trace.replay(spec, ir, s, p, sig)
                for (n, x), (_, y) in zip(trace.named_leaves(a_sim),
                                          trace.named_leaves(b_sim)):
                    assert x.dtype == y.dtype and torch.equal(x, y), (pc, n)
                for x, y in zip(a_cmd, b_cmd):
                    assert x.dtype == y.dtype and torch.equal(x, y), pc
                if ir.name in gated:
                    # the call's effect shows on some lanes and not others
                    moved = [not torch.equal(x, y) for (_, x), (_, y) in zip(
                        trace.named_leaves(s), trace.named_leaves(b_sim))]
                    assert any(moved), (ir.name, p0)
    # (each server has its own s_done)
    assert gated == {"v_join": ["timer_add", "timer_add"],
                     "v_signal": ["timers_clear"],
                     "s_done": ["interrupt", "interrupt"]}


def _gated_spec(body):
    m = Model("gated", n_ilocals=1, event_cap=8)
    blk = m.block(body)
    m.process("p", entry=blk, count=2)
    spec = m.build()
    return spec, loop.init_sim(spec, 1, torch.arange(2), device="cpu")


def test_partial_select_of_a_call_raises():
    """A select that keeps or drops a call's effect on only some of the
    leaves it touches (here the event table, not the error code) cannot
    be a gated call: TraceError naming the block and the select's line."""
    from cimba_tpu_torch import tree
    from cimba_tpu_torch.core import api

    def partial(sim, p, sig):
        late = sim.clock > 1.0
        sim2, _ = api.timer_add(sim, p, 2.0, 7)
        events = tree.map(lambda x, y: torch.where(
            late.reshape((-1,) + (1,) * (x.dim() - 1)), x, y),
            sim.events, sim2.events)
        return sim2._replace(events=events), cmd.hold(1.0, next_pc=0)

    spec, s = _gated_spec(partial)
    with pytest.raises(trace.TraceError,
                       match=r"block 'partial'.*select at .*test_torch_trace"
                             r".*timer_add.*leaves .* out"):
        trace.trace_block(spec, 0, s)


def test_read_after_a_gated_call_outside_its_select_raises():
    """A value read from the state after a gated call, other than
    through the select, would see the call's effect where the gate is
    shut: TraceError."""
    from cimba_tpu_torch import tree
    from cimba_tpu_torch.core import api

    def leaky(sim, p, sig):
        late = sim.clock > 1.0
        sim2 = api.interrupt(sim, None, 1 - p, 3)
        seq = sim2.events.next_seq  # the call's effect, outside the select
        sim = tree.map(lambda x, y: torch.where(
            late.reshape((-1,) + (1,) * (x.dim() - 1)), x, y), sim2, sim)
        sim = api.set_local_i(sim, p, 0, seq)
        return sim, cmd.hold(1.0, next_pc=0)

    spec, s = _gated_spec(leaky)
    with pytest.raises(trace.TraceError,
                       match=r"block 'leaky'.*reads events.next_seq after "
                             r"the engine call interrupt outside the select"):
        trace.trace_block(spec, 0, s)


def test_timer_handle_replays_and_emits():
    """A block that keeps the handle ``api.timer_add`` returns: the
    replay gives the plain engine's handle bit for bit, and the emitted
    call declares it; a handle of a gated call is refused at emit."""
    from cimba_tpu_torch import tree
    from cimba_tpu_torch.core import api

    def keep(sim, p, sig):
        sim, h = api.timer_add(sim, p, 1.5, 9)
        sim = api.set_local_i(sim, p, 0, h)
        return sim, cmd.hold(1.0, next_pc=0)

    spec, s = _gated_spec(keep)
    ir = trace.trace_block(spec, 0, s)
    p = torch.arange(2, dtype=torch.int32)
    sig = torch.zeros(2, dtype=torch.int32)
    a_sim, _ = keep(s, p, sig)
    b_sim, _ = trace.replay(spec, ir, s, p, sig)
    for (n, x), (_, y) in zip(trace.named_leaves(a_sim),
                              trace.named_leaves(b_sim)):
        assert torch.equal(x, y), n
    assert "const int32_t h0 = timer_add(s, w," in emit.emit(spec, s)

    def gated_keep(sim, p, sig):
        late = sim.clock > 1.0
        sim2, h = api.timer_add(sim, p, 1.5, 9)
        sim = tree.map(lambda x, y: torch.where(
            late.reshape((-1,) + (1,) * (x.dim() - 1)), x, y), sim2, sim)
        sim = api.set_local_i(sim, p, 0, h)
        return sim, cmd.hold(1.0, next_pc=0)

    spec, s = _gated_spec(gated_keep)
    with pytest.raises(NotImplementedError, match="handle of a timer_add"):
        emit.emit(spec, s)


def _park2_state(prof, lanes=LANES):
    """Tutorial 2's park part way (animals holding and pended, the end
    event in the table)."""
    from cimba_tpu_torch.examples import tut_2_park as t2

    with config.profile(prof):
        spec, _ = t2.build()
        s = loop.init_sim(spec, t2.SEED, torch.arange(lanes), device="cpu")
        return spec, loop.make_run(spec, t_end=10.0)(s)


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_handler_and_new_calls_replay(prof):
    """The park's blocks (``dice``, ``pool_preempt``, ``api.schedule``)
    and its handler (seven ``api.stop_process`` calls by compile-time
    pid), and a block releasing a binary resource and stopping a pid it
    computes: each traced on a state part way through a run and
    replayed, bit for bit as the block or handler itself computes."""
    from cimba_tpu_torch.core import api

    spec, s = _park2_state(prof)
    p = torch.arange(LANES, dtype=torch.int32) % spec.n_procs
    sig = torch.tensor([0, -1] * (LANES // 2), dtype=torch.int32)
    with config.profile(prof):
        for pc, blk in enumerate(spec.blocks):
            a_sim, a_cmd = blk(s, p, sig)
            b_sim, b_cmd = trace.replay(spec, trace.trace_block(spec, pc, s),
                                        s, p, sig)
            a_cmd = cmd.normalize(a_cmd, LANES, s.clock.device,
                                  s.clock.dtype)
            for (n, x), (_, y) in zip(trace.named_leaves(a_sim),
                                      trace.named_leaves(b_sim)):
                assert x.dtype == y.dtype and torch.equal(x, y), (pc, n)
            for x, y in zip(a_cmd, b_cmd):
                assert x.dtype == y.dtype and torch.equal(x, y), pc
        ir = trace.trace_handler(spec, 0, s)
        assert ir.cmd == ()
        assert [e[1] for e in ir.effects if e[0] == "call"] == [
            "stop_process"] * 7
        a = spec.user_handlers[0](s, p, sig)
        b = trace.replay(spec, ir, s, p, sig)
        for (n, x), (_, y) in zip(trace.named_leaves(a),
                                  trace.named_leaves(b)):
            assert x.dtype == y.dtype and torch.equal(x, y), n

    m = Model("relstop", n_ilocals=1, event_cap=8)
    res = m.resource("r")
    box = []

    @m.block
    def grab(sim, p, sig):
        return sim, cmd.acquire(res.id, next_pc=drop.pc)

    @m.block
    def drop(sim, p, sig):
        mine = api.resource_holder(sim, res) == p
        sim2 = api.release(sim, box[0], res, p)
        sim = loop._where(mine, sim2, sim)
        sim = api.stop_process(sim, box[0], torch.where(p == 2, 0, p + 1))
        return sim, cmd.hold(1.0, next_pc=grab.pc)

    m.process("p", entry=grab, count=3)
    box.append(m.build())
    with config.profile(prof):
        spec = box[0]
        s = loop.init_sim(spec, 1, torch.arange(LANES), device="cpu")
        s = loop.make_run(spec, max_steps=2)(s)
        ir = trace.trace_block(spec, 1, s)
        assert [(e[1], len(e) > 4) for e in ir.effects if e[0] == "call"] \
            == [("release", True), ("stop_process", False)]
        a_sim, _ = drop(s, p % 3, sig)
        b_sim, _ = trace.replay(spec, ir, s, p % 3, sig)
        for (n, x), (_, y) in zip(trace.named_leaves(a_sim),
                                  trace.named_leaves(b_sim)):
            assert torch.equal(x, y), n
        h = emit.emit(spec, s)
    assert "release_resource<0>(s, w, int(" in h
    assert "stop_process(s, w, int(" in h


def test_dice_node_traces_and_emits():
    """``api.draw(sim, cr.dice, a, b)``: one draw node of int64 naming
    the sampler; the replay equals the block; the emitter draws one
    block and calls samplers.cuh's ``dice`` with int64 bounds, and
    refuses a non-integer bound."""
    from cimba_tpu_torch.core import api

    def roll(sim, p, sig):
        sim, k = api.draw(sim, cr.dice, 2, 7)
        sim = api.set_local_i(sim, p, 0, k)
        return sim, cmd.hold(k.to(torch.float64), next_pc=0)

    spec, s = _one_block_spec(roll)
    ir = trace.trace_block(spec, 0, s)
    draws = [ir.nodes[e[1]] for e in ir.effects if e[0] == "draw"]
    assert len(draws) == 1 and draws[0].dtype == torch.int64
    assert draws[0].aux[0] == emit.DICE
    p = torch.zeros(2, dtype=torch.int32)
    sig = torch.zeros(2, dtype=torch.int32)
    a_sim, a_cmd = roll(s, p, sig)
    b_sim, b_cmd = trace.replay(spec, ir, s, p, sig)
    for (n, x), (_, y) in zip(trace.named_leaves(a_sim),
                              trace.named_leaves(b_sim)):
        assert torch.equal(x, y), n
    h = emit.emit(spec, s)
    assert "dice(b" in h and "int64_t(2LL), int64_t(7LL));" in h

    def roll_f(sim, p, sig):
        sim, k = api.draw(sim, cr.dice, 2.0, 7.0)
        return sim, cmd.hold(k.to(torch.float64), next_pc=0)

    spec, s = _one_block_spec(roll_f)
    with pytest.raises(NotImplementedError, match="non-integer bound"):
        emit.emit(spec, s)


def test_gated_schedule_handle_raises_trace_error():
    """The handle of an ``api.schedule`` that a select keeps or drops
    names no event where the gate is shut: TraceError at emit, naming
    the block and the call."""
    from cimba_tpu_torch import tree
    from cimba_tpu_torch.core import api

    m = Model("gsched", n_ilocals=1, event_cap=8)

    @m.handler
    def noop(sim, subj, arg):
        return sim

    def keep(sim, p, sig):
        late = sim.clock > 1.0
        sim2, h = api.schedule(sim, 3.0, 0, noop)
        sim = tree.map(lambda x, y: torch.where(
            late.reshape((-1,) + (1,) * (x.dim() - 1)), x, y), sim2, sim)
        sim = api.set_local_i(sim, p, 0, h)
        return sim, cmd.hold(1.0, next_pc=0)

    m.process("p", entry=m.block(keep))
    spec = m.build()
    s = loop.init_sim(spec, 1, torch.arange(2), device="cpu")
    with pytest.raises(trace.TraceError,
                       match=r"block 'keep'.*handle of a schedule"):
        emit.emit(spec, s)


def _spawn_spec(body):
    m = Model("spawner", n_flocals=1, n_ilocals=1, event_cap=8)
    blk = m.block(body)

    @m.block
    def child(sim, p, sig):
        return sim, cmd.hold(2.0, next_pc=gone.pc)

    @m.block
    def gone(sim, p, sig):
        return sim, cmd.exit_()

    m.process("door", entry=blk, prio=1)
    box.append(m.process("kids", entry=child, count=2, start=False))
    spec = m.build()
    return spec, loop.init_sim(spec, 1, torch.arange(LANES), device="cpu")


box = []


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_spawn_replays_and_emits(prof):
    """Three spawns into a pool of two (the third finds none while the
    first two hold: pid -1), one at a traced time and priority; the pids
    in arithmetic, kept in a local and the user state: the replay equals
    the block bit for bit on a fresh state and part way through a run
    (rows running, finished and recycled), and the emitter calls the
    pool's rule with each pid kept."""
    from cimba_tpu_torch.core import api

    def door(sim, p, sig):
        sim, a = api.spawn(sim, box[-1])
        sim, b = api.spawn(sim, box[-1], at=api.clock(sim) + 0.5,
                           prio=a + 3)
        sim, c = api.spawn(sim, box[-1])
        sim = api.set_local_i(sim, p, 0, a * 100 + b * 10 + (c < 0).to(
            torch.int32))
        return sim, cmd.hold(1.5, next_pc=0)

    with config.profile(prof):
        spec, s = _spawn_spec(door)
        ir = trace.trace_block(spec, 0, s)
        assert [e[1] for e in ir.effects if e[0] == "call"] == ["spawn"] * 3
        p = torch.zeros(LANES, dtype=torch.int32)
        sig = torch.zeros(LANES, dtype=torch.int32)
        for steps in (0, 5, 9):
            st = loop.make_run(spec, max_steps=steps)(s) if steps else s
            a_sim, a_cmd = door(st, p, sig)
            b_sim, b_cmd = trace.replay(spec, ir, st, p, sig)
            for (n, x), (_, y) in zip(trace.named_leaves(a_sim),
                                      trace.named_leaves(b_sim)):
                assert x.dtype == y.dtype and torch.equal(x, y), (steps, n)
            assert bool((b_sim.procs.locals_i[:, 0, 0] % 10 == 1).any())
        h = emit.emit(spec, s)
    for piece in ("const int32_t h0 = spawn_pool<0>(s, w, s.clock, "
                  "int32_t(0));", "const int32_t h1 = spawn_pool<0>(s, w, ",
                  "const int32_t h2 = spawn_pool<0>(s, w, s.clock,",
                  "type 0 'kids' pids [1, 3)"):
        assert piece in h, piece


def test_gated_spawn_pid_raises_trace_error():
    """A spawn that a select of the whole Sim keeps or drops runs under
    its gate in the kernel: its pid names nothing where the gate is
    shut, so a use of it is a TraceError naming the block and the
    select's line; the gated spawn whose pid is unused traces."""
    from cimba_tpu_torch import tree
    from cimba_tpu_torch.core import api

    def keep(sim, p, sig):
        late = sim.clock > 1.0
        sim2, pid = api.spawn(sim, box[-1])
        sim = tree.map(lambda x, y: torch.where(
            late.reshape((-1,) + (1,) * (x.dim() - 1)), x, y), sim2, sim)
        sim = api.set_local_i(sim, p, 0, pid)
        return sim, cmd.hold(1.0, next_pc=0)

    spec, s = _spawn_spec(keep)
    with pytest.raises(trace.TraceError,
                       match=r"block 'keep'.*uses the pid of a spawn that "
                             r"the select at .*test_torch_trace"):
        trace.trace_block(spec, 0, s)

    def drop_pid(sim, p, sig):
        late = sim.clock > 1.0
        sim2, _ = api.spawn(sim, box[-1])
        sim = tree.map(lambda x, y: torch.where(
            late.reshape((-1,) + (1,) * (x.dim() - 1)), x, y), sim2, sim)
        return sim, cmd.hold(1.0, next_pc=0)

    spec, s = _spawn_spec(drop_pid)
    ir = trace.trace_block(spec, 0, s)
    assert [(e[1], len(e) > 4) for e in ir.effects if e[0] == "call"] == [
        ("spawn", True)]
    assert "if (v" in emit.emit(spec, s)


evbox = {}


def _event_api_spec(body):
    m = Model("evapi", n_flocals=1, n_ilocals=2, event_cap=8)
    m.objectqueue("q", capacity=4, record=False)
    pq = m.priorityqueue("pq", capacity=4, record=True)

    @m.handler
    def noop(sim, subj, arg):
        return sim

    @m.block
    def fill(sim, p, sig):
        return sim, cmd.select(p == 0, cmd.put(0, 2.0, next_pc=1),
                               cmd.pq_put(0, 2.0, 1.0, next_pc=1))

    m.block(body)
    m.process("p", entry=fill, count=3)
    evbox.update(noop=noop, pq=pq)
    spec = m.build()
    evbox["spec"] = spec
    return spec, loop.init_sim(spec, 1, torch.arange(LANES), device="cpu")


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_event_api_calls_and_readers_replay_and_emit(prof):
    """Every call and reader of the event-handle API, the priority
    queue's item verbs, ``priority_set`` and ``queue_position`` in one
    block (some of the calls gated by a select of the whole Sim, the
    others' results used): the replay equals the block bit for bit on a
    fresh state and part way through a run, and the emitter writes each
    call and reader."""
    from cimba_tpu_torch import tree
    from cimba_tpu_torch.core import api

    def sel(pred, a, b):
        return tree.map(lambda x, y: torch.where(
            pred.reshape((-1,) + (1,) * (x.dim() - 1)), x, y), a, b)

    def body(sim, p, sig):
        noop, pq = evbox["noop"], evbox["pq"]
        late = sim.clock > 0.5
        sim, h1 = api.schedule(sim, api.clock(sim) + 3.0, 1, noop, subj=p)
        sim, h2 = api.schedule(sim, api.clock(sim) + 2.0, 0, noop, arg=4)
        look = (api.event_is_scheduled(sim, h1).to(torch.int32)
                + api.event_priority(sim, h1) * 10
                + api.event_pattern_count(sim, kind=noop) * 100
                + (api.event_pattern_find(sim, subj=p) == h1).to(
                    torch.int32) * 1000)
        t = api.event_time(sim, h2)
        sim, ok1 = api.event_reschedule(sim, h1, t + 1.0)
        sim, ok2 = api.event_reprioritize(sim, h2, 7)
        sim = sel(late, api.event_cancel(sim, h2, evbox["spec"])[0], sim)
        sim, ok3 = api.timer_cancel(sim, h1)
        sim, n = api.event_pattern_cancel(sim, kind=noop, subj=p)
        sim = sel(late, api.priority_set(sim, p, 4), sim)
        sim, ok4 = api.pqueue_cancel(sim, pq, 2.0)
        sim = sel(late, api.pqueue_reprioritize(sim, pq, 2.0, 5.0)[0], sim)
        look = look + (ok1 & ok2 & ok3 & ok4).to(torch.int32) * 10000 + n
        sim = api.set_local_i(sim, p, 0, look)
        sim = api.set_local_i(sim, p, 1, api.queue_position(sim, 0, 2.0))
        sim = api.set_local_f(sim, p, 0, t)
        return sim, cmd.hold(0.7, next_pc=1)

    with config.profile(prof):
        spec, s = _event_api_spec(body)
        ir = trace.trace_block(spec, 1, s)
        assert [e[1] for e in ir.effects if e[0] == "call"] == [
            "schedule", "schedule", "event_reschedule", "event_reprioritize",
            "event_cancel", "event_cancel", "event_pattern_cancel",
            "priority_set", "pqueue_cancel", "pqueue_reprioritize"]
        gated = [e[1] for e in ir.effects if e[0] == "call" and len(e) > 4]
        assert gated == ["event_cancel", "priority_set",
                         "pqueue_reprioritize"]
        sig = torch.zeros(LANES, dtype=torch.int32)
        for steps in (0, 2, 5):
            st = loop.make_run(spec, max_steps=steps)(s) if steps else s
            for p0 in range(3):
                p = torch.full((LANES,), p0, dtype=torch.int32)
                a_sim, a_cmd = body(st, p, sig)
                b_sim, b_cmd = trace.replay(spec, ir, st, p, sig)
                for (n, x), (_, y) in zip(trace.named_leaves(a_sim),
                                          trace.named_leaves(b_sim)):
                    assert x.dtype == y.dtype and torch.equal(x, y), (
                        steps, p0, n)
        h = emit.emit(spec, s)
    for piece in ("= ev_valid(s, w, ", "= ev_prio(s, w, ",
                  "= pattern_count(s, w, int32_t(2), int32_t(-1))",
                  "= pattern_find(s, w, int32_t(-1), ", "= ev_time(s, w, ",
                  "const bool h2 = event_reschedule(s, w, ",
                  "const bool h3 = event_reprioritize(s, w, ",
                  "  event_cancel<true>(s, w, ",
                  "const bool h5 = event_cancel<false>(s, w, ",
                  "const int32_t h6 = pattern_cancel(s, w, int32_t(2), ",
                  "  priority_set(s, w, int(",
                  "const bool h8 = pq_cancel<0>(s, w, ",
                  "  pq_reprioritize<0>(s, w, ",
                  "= queue_position<0>(s, w, ",
                  "WAITP = false, WAITE = false;"):
        assert piece in h, piece


def test_gated_cancel_result_raises_trace_error():
    """The ``existed`` of an ``api.event_cancel`` that a select of the
    whole Sim keeps or drops means nothing where the gate is shut: its
    use is a TraceError naming the block and the select's line."""
    from cimba_tpu_torch import tree
    from cimba_tpu_torch.core import api

    def keep(sim, p, sig):
        late = sim.clock > 1.0
        sim2, ok = api.event_cancel(sim, api.local_i(sim, p, 0))
        sim = tree.map(lambda x, y: torch.where(
            late.reshape((-1,) + (1,) * (x.dim() - 1)), x, y), sim2, sim)
        sim = api.set_local_i(sim, p, 0, ok.to(torch.int32))
        return sim, cmd.hold(1.0, next_pc=0)

    spec, s = _gated_spec(keep)
    with pytest.raises(trace.TraceError,
                       match=r"block 'keep'.*uses the result of a "
                             r"event_cancel that the select at "
                             r".*test_torch_trace"):
        trace.trace_block(spec, 0, s)


def test_waits_set_the_header_flags():
    """A block that may return ``wait_process`` or ``wait_event`` turns on
    the kernel's waits (``WAITP``, ``WAITE``); the other family keeps
    them off."""
    def waits(sim, p, sig):
        return sim, cmd.select(p == 0, cmd.wait_process(1, next_pc=0),
                               cmd.wait_event(api_local(sim, p), next_pc=0))

    def api_local(sim, p):
        from cimba_tpu_torch.core import api

        return api.local_i(sim, p, 0)

    spec, s = _gated_spec(waits)
    assert "WAITP = true, WAITE = true;" in emit.emit(spec, s)

    def only_proc(sim, p, sig):
        return sim, cmd.wait_process(1 - p, next_pc=0)

    spec, s = _gated_spec(only_proc)
    assert "WAITP = true, WAITE = false;" in emit.emit(spec, s)
