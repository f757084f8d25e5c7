"""A seeded generator of user specs over the port's toolkit.

``build(seed, lib)`` makes one random model written only with the model
DSL, as a user writes it: an object queue with the fused verbs, one or
two resource pools, a buffer, a condition whose predicate reads its
waiter's own local, ``cmd.select`` (between verbs and between component
ids), ``jump``, ``exit``, ``api.stop``, inline and command releases, an
explicit ``cond_signal`` and draws from every device sampler.  The same
code builds the spec in either package: ``lib`` carries the DSL modules
(:func:`torch_lib` for this port; the tests pass the JAX package's), so
one seed gives the same model in both.  Every lane ends, by ``api.stop``
once ``n_items`` items are done.

``build(seed, lib, timers=True)`` makes the same kind of model with the
later verbs: a priority queue (puts at a drawn priority, plain or fused
gets) in place of the object queue; a timeout on each consumer's plain
pool acquire (a timer, then the acquire: a timed-out waiter's partial
grab rolls back, and it tries again) and on the drain's plain buffer get
(a timed-out get keeps its partial take, reported in ``api.got``); the
timers cleared on success (``api.timers_clear``, kept or dropped by a
select of the whole Sim); and the watcher interrupting a consumer it
draws, which may be holding or pended (on the pool, the priority queue
or the buffer).  Lost items are possible there, so such a model runs to
a horizon.

``build(seed, lib, resources=True)`` makes a model of the verbs of
binary resources, preemption and user events: workers that take a
binary resource by ``acquire`` (plain or fused), the first under a
timeout (a timer, then the acquire; the timer cleared on success), and
give it back with ``api.release`` where they still hold it; a boss that
takes it by ``preempt`` (plain or fused), kicking a worker; a middle
process that preempts it under a timeout, so its pended preempt can be
aborted; two processes of low priority that take pool units by
``pool_acquire`` and a mugger of higher priority that takes them by
``pool_preempt`` (plain or fused; a plain one under a timeout, so a
pended pool preempt rolls back); and a starter that schedules a user
event (``api.schedule``) whose handler stops one process it names by
the event's subject.  Such a model runs to a horizon.

``build(seed, lib, spawn=True)`` makes a model of spawn pools
(``process(start=False)``, ``api.spawn``) with 11 to 32 processes in all,
past the generated kernel's old limit of 10: a door that spawns a client
process per arrival from a pool of 7 to 30 rows, some at a later time
(``at``) or at another priority (``prio``), into an overloaded desk (a
binary resource, plain or fused acquire, command or inline release), so
the pool runs out and a spawn returns -1, and finished rows are
recycled; where a second pool of 1 to 3 runners exists, the door spawns
one a arrival too (runners take a unit of a resource pool, hold it and
give it back); its first block spawns the smaller pool one more time than
it has rows, so every lane sees a -1; a watcher waits on a condition that
observes the desk and is never signalled by hand.  Some seeds declare six
spare resources first, so the spec has 9 guards and its desk, pool and
condition take guard ids past 7.  Every lane ends: the door exits after
``n_items`` arrivals, and the clients and runners finish.

``build(seed, lib, waits=True)`` makes a model of the waits and the
event-handle API, 9 to 18 processes: a dispatcher that joins 3 to 8
workers one after another by ``wait_process`` (one exits at its start,
so it has finished when joined; one holds long and is stopped by
``stop_process``, before or after the dispatcher reaches it); a
watcher that schedules a user event and ``wait_event``s its handle,
which a controller reschedules, reprioritizes, or cancels with the spec
(the eager arm) or without it (the lazy arm), or, on some seeds, cancels
lazily as the lane's last activity, so that the cancel drains the event
set and only the stranding term keeps the lane live; a process that sets
three timers on itself, is woken by the first, and counts, finds and
cancels the rest by pattern (``event_pattern_count``, ``_find``,
``_cancel``); an impatient acquirer of a binary resource whose timeout
is cancelled by handle (``timer_cancel``) on success, kept or dropped
by a select of the whole Sim; on some seeds a claimant pended on the
resource's guard whose priority a booster raises (``priority_set``);
and on some seeds a priority queue of two whose third put blocks until
``pqueue_cancel`` frees it, a ``pqueue_reprioritize``, and a
``queue_position`` of an object queue read into a local.  Every lane
ends: each process exits.

On the card a spec built here takes the generated chunk kernel
(``core/kernel_run.generated_kernel_for``), which the tests and
``chip_smoke.py`` hold against the plain engine.
"""

from __future__ import annotations

import random
import types


def torch_lib():
    """The port's DSL modules, as :func:`build` takes them."""
    import torch

    import cimba_tpu_torch.random as cr
    from cimba_tpu_torch import config
    from cimba_tpu_torch.core import api
    from cimba_tpu_torch.core import process as cmd
    from cimba_tpu_torch.core.model import Model
    from cimba_tpu_torch.stats import summary as sm
    from cimba_tpu_torch.utils import dbc, logger

    return types.SimpleNamespace(
        Model=Model, api=api, cmd=cmd, cr=cr, logger=logger, dbc=dbc,
        zeros_i=lambda: torch.zeros((), dtype=torch.int32),
        real=lambda v: torch.tensor(v, dtype=config.real()),
        where=torch.where, empty=lambda: sm.empty((), "cpu"), add=sm.add,
        floor=torch.floor, i32=lambda x: x.to(torch.int32),
        real_of=lambda x: x.to(config.real()),
        select_sim=_torch_select_sim)


def _torch_select_sim(pred, a, b):
    """``pred ? a : b`` over every leaf, lane by lane (the JAX package's
    ``jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)``)."""
    import torch

    from cimba_tpu_torch import tree

    return tree.map(lambda x, y: torch.where(
        pred.reshape((-1,) + (1,) * (x.dim() - 1)), x, y), a, b)


#: the signals the timed model's timers and interrupts deliver
TIMEOUT, INTERRUPTED = -5, -2


def build(seed: int, lib, timers: bool = False, resources: bool = False,
          spawn: bool = False, waits: bool = False):
    """One random spec; returns ``(spec, n_items)`` (``n_items`` None for
    a ``resources`` or a ``waits`` spec; the door's arrivals for a
    ``spawn`` one)."""
    if resources:
        return _build_resources(seed, lib), None
    if waits:
        return _build_waits(seed, lib), None
    if spawn:
        return _build_spawn(seed, lib)
    rng = random.Random(seed)
    Model, api, cmd, cr = lib.Model, lib.api, lib.cmd, lib.cr
    n_items = rng.randint(12, 30)
    arr_mean = rng.uniform(0.5, 1.5)
    srv_mean = rng.uniform(0.3, 1.2)
    n_cons = rng.randint(1, 3)
    fused = rng.random() < 0.5
    two_pools = rng.random() < 0.5
    inline_release = rng.random() < 0.5
    thr = float(rng.randint(2, 6))
    take = rng.choice([0.5, 1.0])

    if timers:
        patience = rng.uniform(0.2, 1.5)
        d_patience = rng.uniform(0.3, 1.5)
        intr_every = rng.uniform(1.0, 4.0)
        # claims and takes that whole units do not fill, so a timeout
        # or an interrupt finds a partial grab or take; all units held
        # go back inline
        need = 1.5
        take = take + 1.0
        inline_release = True
    m = Model(f"usergen{'t' if timers else ''}{seed}", n_flocals=1,
              n_ilocals=1, event_cap=8, guard_cap=8)
    if timers:
        q = m.priorityqueue("q", capacity=rng.randint(4, 16),
                            record=rng.random() < 0.5)
    else:
        q = m.objectqueue("q", capacity=rng.randint(4, 16),
                          record=rng.random() < 0.5)
    pa = m.resourcepool("pa", capacity=float(rng.randint(2, 3)),
                        record=rng.random() < 0.5)
    pb = (m.resourcepool("pb", capacity=2.0, record=False) if two_pools
          else pa)
    buf = m.buffer("buf", capacity=float(rng.randint(8, 20)),
                   initial=float(rng.randint(0, 3)),
                   record=rng.random() < 0.5)

    def full(sim, pid):
        return api.buffer_level(sim, buf) >= thr + api.local_f(sim, pid, 0)

    cv = m.condition("full", full, observes=[buf])
    box = []

    @m.user_state
    def init(params):
        u = {"done_n": lib.zeros_i(), "watched": lib.zeros_i(),
             "srv_mean": lib.real(srv_mean), "w": lib.empty()}
        if timers:
            u.update(timeouts=lib.zeros_i(), partial=lib.real(0.0))
        return u

    # --- producer: n_items items into q ----------------------------------
    @m.block
    def produce(sim, p, sig):
        made = api.local_i(sim, p, 0)
        fin = made >= n_items
        sim = api.add_local_i(sim, p, 0, 1)
        sim, t = api.draw(sim, cr.exponential, arr_mean)
        if timers:
            sim, u = api.draw(sim, cr.uniform01)
            prio = lib.floor(u * 3.0)
            put = (cmd.pq_put_hold(q.id, api.clock(sim), prio, t,
                                   next_pc=produce.pc)
                   if fused else cmd.pq_put(q.id, api.clock(sim), prio,
                                            next_pc=p_wait.pc))
        else:
            put = (cmd.put_hold(q.id, api.clock(sim), t, next_pc=produce.pc)
                   if fused else cmd.put(q.id, api.clock(sim),
                                         next_pc=p_wait.pc))
        return sim, cmd.select(fin, cmd.exit_(), put)

    @m.block
    def p_wait(sim, p, sig):
        sim, t = api.draw(sim, cr.uniform, 0.5 * arr_mean, 1.5 * arr_mean)
        return sim, cmd.hold(t, next_pc=produce.pc)

    # --- consumers: get, a pool (which one by a draw), service, a buffer
    # put, the release, the statistic --------------------------------------
    @m.block
    def c_get(sim, p, sig):
        if fused:
            sim, t = api.draw(sim, cr.exponential, sim.user["srv_mean"])
            if timers:
                return sim, cmd.pq_get_hold(q.id, t, next_pc=c_acq.pc)
            return sim, cmd.get_hold(q.id, t, next_pc=c_acq.pc)
        if timers:
            return sim, cmd.pq_get(q.id, next_pc=c_acq.pc)
        return sim, cmd.get(q.id, next_pc=c_acq.pc)

    if timers:
        @m.block
        def c_acq(sim, p, sig):
            # a plain acquire under a timeout: a timed-out (or
            # interrupted) waiter's partial grab rolls back
            sim, u = api.draw(sim, cr.triangular, 0.0, 0.3, 1.0)
            sim, _ = api.timer_add(sim, p, patience, TIMEOUT)
            use_b = u < 0.5
            return sim, cmd.select(
                use_b, cmd.pool_acquire(pb.id, need, next_pc=c_won.pc),
                cmd.pool_acquire(pa.id, need, next_pc=c_won.pc))

        @m.block
        def c_won(sim, p, sig):
            # granted, or interrupted while waiting: the timer is cleared
            # (a timeout's own timer has fired)
            ok = sig == 0
            timed_out = sig == TIMEOUT
            u = sim.user
            sim = api.set_user(sim, {**u, "timeouts": u["timeouts"]
                                     + lib.i32(lib.where(timed_out, 1, 0))})
            sim = lib.select_sim(timed_out, sim, api.timers_clear(sim, p))
            sim, t = api.draw(sim, cr.lognormal, -0.5, 0.4)
            return sim, cmd.select(ok, cmd.hold(t, next_pc=c_put.pc),
                                   cmd.jump(c_acq.pc))
    else:
        @m.block
        def c_acq(sim, p, sig):
            sim, u = api.draw(sim, cr.triangular, 0.0, 0.3, 1.0)
            sim, t = api.draw(sim, cr.lognormal, -0.5, 0.4)
            use_b = u < 0.5
            return sim, cmd.select(
                use_b,
                cmd.pool_acquire_hold(pb.id, 1.0, t, next_pc=c_put.pc),
                cmd.pool_acquire_hold(pa.id, 1.0, t, next_pc=c_put.pc))

    @m.block
    def c_put(sim, p, sig):
        sim = api.set_local_f(sim, p, 0, api.clock(sim))
        return sim, cmd.buffer_put(buf.id, 1.0, next_pc=c_rel.pc)

    @m.block
    def c_rel(sim, p, sig):
        if inline_release:
            sim = api.pool_release(sim, box[0], pa, p,
                                   api.pool_held(sim, pa, p))
            if two_pools:
                sim = api.pool_release(sim, box[0], pb, p,
                                       api.pool_held(sim, pb, p))
            return sim, cmd.jump(c_rec.pc)
        held_a = api.pool_held(sim, pa, p) > 0.0
        return sim, cmd.select(
            held_a, cmd.pool_release(pa.id, 1.0, next_pc=c_rec.pc),
            cmd.pool_release(pb.id, 1.0, next_pc=c_rec.pc))

    @m.block
    def c_rec(sim, p, sig):
        u = sim.user
        w = lib.add(u["w"], api.clock(sim) - api.got(sim, p))
        n = u["done_n"] + 1
        sim = api.set_user(sim, {**u, "w": w, "done_n": n})
        sim = api.stop(sim, n >= n_items)
        sim = api.cond_signal(sim, box[0], cv)
        return sim, cmd.jump(c_get.pc)

    # --- the drain: takes from the buffer ---------------------------------
    if timers:
        @m.block
        def d_get(sim, p, sig):
            # a plain get under a timeout: a timed-out get keeps its
            # partial take, reported in got
            sim, _ = api.timer_add(sim, p, d_patience, TIMEOUT)
            return sim, cmd.buffer_get(buf.id, take, next_pc=d_got.pc)

        @m.block
        def d_got(sim, p, sig):
            ok = sig == 0
            u = sim.user
            sim = api.set_user(sim, {**u, "partial": u["partial"]
                                     + lib.where(ok, 0.0, api.got(sim, p))})
            sim = api.timers_clear(sim, p)
            sim, t = api.draw(sim, cr.normal, 1.0, 0.25)
            return sim, cmd.hold(lib.where(t > 0.1, t, 0.1),
                                 next_pc=d_get.pc)
    else:
        @m.block
        def d_get(sim, p, sig):
            sim, t = api.draw(sim, cr.normal, 1.0, 0.25)
            return sim, cmd.buffer_get_hold(buf.id, take, lib.where(
                t > 0.1, t, 0.1), next_pc=d_get.pc)

    # --- the watcher: waits until the buffer holds its own threshold ------
    @m.block
    def w_arm(sim, p, sig):
        sim, x = api.draw(sim, cr.uniform, 0.0, 2.0)
        sim = api.set_local_f(sim, p, 0, x)
        return sim, cmd.cond_wait(cv.id, next_pc=w_seen.pc)

    @m.block
    def w_seen(sim, p, sig):
        u = sim.user
        sim = api.set_user(sim, {**u, "watched": u["watched"] + 1})
        if timers:
            return sim, cmd.hold(intr_every, next_pc=w_poke.pc)
        return sim, cmd.hold(1.0, next_pc=w_arm.pc)

    if timers:
        @m.block
        def w_poke(sim, p, sig):
            # interrupt a consumer (pids 1 .. n_cons), holding or pended
            sim, u = api.draw(sim, cr.uniform01)
            target = lib.floor(u * n_cons) + 1.0
            sim = api.interrupt(sim, box[0], lib.i32(target), INTERRUPTED)
            return sim, cmd.jump(w_arm.pc)

    m.process("producer", entry=produce)
    m.process("consumer", entry=c_get, count=n_cons)
    m.process("drain", entry=d_get)
    m.process("watcher", entry=w_arm, prio=1)
    spec = m.build()
    box.append(spec)
    return spec, n_items


def _build_resources(seed: int, lib):
    """The ``resources=True`` family (see the module's docstring)."""
    rng = random.Random(seed)
    Model, api, cmd, cr = lib.Model, lib.api, lib.cmd, lib.cr
    n_work = rng.randint(1, 2)
    n_low = rng.randint(1, 2)
    work_mean = rng.uniform(0.5, 1.5)
    boss_every = rng.uniform(1.0, 3.0)
    patience = rng.uniform(0.3, 1.5)
    fused_acq = rng.random() < 0.5
    fused_pre = rng.random() < 0.5
    fused_mug = rng.random() < 0.5
    t_stop = rng.uniform(8.0, 20.0)
    m = Model(f"usergenr{seed}", n_flocals=1, n_ilocals=1, event_cap=16,
              guard_cap=8)
    tool = m.resource("tool", record=rng.random() < 0.5)
    pool = m.resourcepool("units", capacity=float(rng.randint(3, 5)),
                          record=rng.random() < 0.5)
    box = []

    @m.user_state
    def init(params):
        return {"grants": lib.zeros_i(), "timeouts": lib.zeros_i(),
                "kicked": lib.zeros_i(), "mugged": lib.zeros_i()}

    def count(sim, key, pred):
        u = sim.user
        return api.set_user(sim, {**u, key: u[key]
                                  + lib.i32(lib.where(pred, 1, 0))})

    def give_back(sim, p):
        """release the tool where p still holds it (a kicked worker does
        not)"""
        mine = api.resource_holder(sim, tool) == p
        return lib.select_sim(mine, api.release(sim, box[0], tool, p), sim)

    # --- workers: the tool, the first one under a timeout ------------------
    @m.block
    def w_start(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, work_mean)
        timed = p == 0
        sim = lib.select_sim(timed, api.timer_add(sim, p, patience,
                                                  TIMEOUT)[0], sim)
        acq = (cmd.acquire_hold(tool.id, t, next_pc=w_done.pc) if fused_acq
               else cmd.acquire(tool.id, next_pc=w_got.pc))
        return sim, cmd.select(timed, cmd.acquire(tool.id, next_pc=w_got.pc),
                               acq)

    @m.block
    def w_got(sim, p, sig):
        ok = sig == 0
        sim = count(sim, "timeouts", sig == TIMEOUT)
        sim = count(sim, "grants", ok)
        sim = lib.select_sim(ok, api.timers_clear(sim, p), sim)
        sim, t = api.draw(sim, cr.exponential, work_mean)
        return sim, cmd.select(ok, cmd.hold(t, next_pc=w_done.pc),
                               cmd.jump(w_start.pc))

    @m.block
    def w_done(sim, p, sig):
        sim = count(sim, "kicked", sig == pr_preempted)
        sim = give_back(sim, p)
        sim, t = api.draw(sim, cr.uniform, 0.1, 0.5)
        return sim, cmd.hold(t, next_pc=w_start.pc)

    # --- the boss preempts the tool; the middle one under a timeout --------
    @m.block
    def b_wait(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, boss_every)
        return sim, cmd.hold(t, next_pc=b_take.pc)

    @m.block
    def b_take(sim, p, sig):
        sim, t = api.draw(sim, cr.uniform, 0.2, 0.8)
        return sim, (cmd.preempt_hold(tool.id, t, next_pc=b_rel.pc)
                     if fused_pre else cmd.preempt(tool.id,
                                                   next_pc=b_hold.pc))

    @m.block
    def b_hold(sim, p, sig):
        sim, t = api.draw(sim, cr.uniform, 0.2, 0.8)
        return sim, cmd.hold(t, next_pc=b_rel.pc)

    @m.block
    def b_rel(sim, p, sig):
        sim = give_back(sim, p)
        return sim, cmd.jump(b_wait.pc)

    @m.block
    def m_take(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, boss_every)
        sim, _ = api.timer_add(sim, p, patience, TIMEOUT)
        return sim, cmd.preempt(tool.id, next_pc=m_got.pc)

    @m.block
    def m_got(sim, p, sig):
        ok = sig == 0
        sim = count(sim, "timeouts", sig == TIMEOUT)
        sim = lib.select_sim(ok, api.timers_clear(sim, p), sim)
        return sim, cmd.select(ok, cmd.hold(0.3, next_pc=m_rel.pc),
                               cmd.hold(0.5, next_pc=m_take.pc))

    @m.block
    def m_rel(sim, p, sig):
        sim = count(sim, "kicked", sig == pr_preempted)
        sim = give_back(sim, p)
        return sim, cmd.jump(m_take.pc)

    # --- the pool: polite takers and a mugger ------------------------------
    @m.block
    def l_take(sim, p, sig):
        sim, a = api.draw(sim, cr.dice, 1, 2)
        return sim, cmd.pool_acquire(pool.id, lib.real_of(a),
                                     next_pc=l_hold.pc)

    @m.block
    def l_hold(sim, p, sig):
        sim = count(sim, "mugged", sig == pr_preempted)
        sim, t = api.draw(sim, cr.exponential, work_mean)
        return sim, cmd.hold(t, next_pc=l_drop.pc)

    @m.block
    def l_drop(sim, p, sig):
        sim = count(sim, "mugged", sig == pr_preempted)
        sim = api.pool_release(sim, box[0], pool, p,
                               api.pool_held(sim, pool, p))
        return sim, cmd.jump(l_take.pc)

    @m.block
    def g_take(sim, p, sig):
        sim, a = api.draw(sim, cr.dice, 2, 3)
        sim, t = api.draw(sim, cr.exponential, 0.5 * work_mean)
        amt = lib.real_of(a)
        if fused_mug:
            return sim, cmd.pool_preempt_hold(pool.id, amt, t,
                                              next_pc=g_drop.pc)
        sim, _ = api.timer_add(sim, p, patience, TIMEOUT)
        return sim, cmd.pool_preempt(pool.id, amt, next_pc=g_got.pc)

    @m.block
    def g_got(sim, p, sig):
        ok = sig == 0
        sim = count(sim, "timeouts", sig == TIMEOUT)
        sim = lib.select_sim(ok, api.timers_clear(sim, p), sim)
        return sim, cmd.select(ok, cmd.hold(0.4, next_pc=g_drop.pc),
                               cmd.hold(0.2, next_pc=g_take.pc))

    @m.block
    def g_drop(sim, p, sig):
        sim = api.pool_release(sim, box[0], pool, p,
                               api.pool_held(sim, pool, p))
        sim, t = api.draw(sim, cr.exponential, work_mean)
        return sim, cmd.hold(t, next_pc=g_take.pc)

    # --- the end of one process, by a user event ---------------------------
    @m.handler
    def stopper(sim, subj, arg):
        sim = api.stop_process(sim, box[0], subj)
        u = sim.user
        return api.set_user(sim, {**u, "grants": u["grants"] + arg})

    @m.block
    def starter(sim, p, sig):
        sim, u = api.draw(sim, cr.uniform01)
        victim = lib.i32(lib.floor(u * n_procs))
        sim, _ = api.schedule(sim, t_stop, 3, stopper, victim, 100)
        return sim, cmd.exit_()

    pr_preempted = -1
    m.process("worker", entry=w_start, count=n_work)  # pids 0 ..
    m.process("boss", entry=b_wait, prio=2)
    m.process("middle", entry=m_take, prio=1)
    m.process("low", entry=l_take, count=n_low)
    m.process("mugger", entry=g_take, prio=rng.choice([1, 3]))
    m.process("starter", entry=starter, prio=4)
    n_procs = n_work + n_low + 4
    spec = m.build()
    box.append(spec)
    return spec


def _build_spawn(seed: int, lib):
    """The ``spawn=True`` family (see the module's docstring)."""
    rng = random.Random(seed)
    Model, api, cmd, cr = lib.Model, lib.api, lib.cmd, lib.cr
    two = rng.random() < 0.5
    n_b = rng.randint(1, 3) if two else 0
    n_a = rng.randint(9 - n_b, 30 - n_b)
    n_items = n_a + rng.randint(8, 20)
    arr_mean = rng.uniform(0.3, 0.6)
    srv_mean = rng.uniform(0.6, 1.0)
    fused = rng.random() < 0.5
    inline_release = rng.random() < 0.5
    at_delay = rng.choice([None, rng.uniform(0.1, 2.0)])
    prio = rng.choice([None, 1])
    n_spare = rng.choice([0, 6])
    m = Model(f"usergens{seed}", n_flocals=1, n_ilocals=1, event_cap=16)
    for i in range(n_spare):
        m.resource(f"spare{i}", record=False)
    desk = m.resource("desk", record=rng.random() < 0.5)
    seats = m.resourcepool("seats", capacity=float(rng.randint(1, 3)),
                           record=rng.random() < 0.5)
    free = m.condition(
        "desk_free", lambda sim, pid: api.resource_holder(sim, desk) < 0,
        observes=[desk])
    box = []

    @m.user_state
    def init(params):
        return {"arrivals": lib.zeros_i(), "spawned": lib.zeros_i(),
                "missed": lib.zeros_i(), "served": lib.zeros_i(),
                "seen": lib.zeros_i(), "sum_t": lib.real(0.0)}

    def count(sim, key, v):
        u = sim.user
        return api.set_user(sim, {**u, key: u[key] + v})

    def spawned(sim, pid):
        sim = count(sim, "spawned", lib.i32(lib.where(pid >= 0, 1, 0)))
        return count(sim, "missed", lib.i32(lib.where(pid < 0, 1, 0)))

    # --- the door: a burst into the smaller pool, then one client an
    # arrival (and a runner where there are runners) ------------------------
    @m.block
    def d_burst(sim, p, sig):
        small = runners if two else clients
        for _ in range(small.count + 1):
            sim, pid = api.spawn(sim, small)
            sim = spawned(sim, pid)
        return sim, cmd.jump(d_arrive.pc)

    @m.block
    def d_arrive(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, arr_mean)
        return sim, cmd.hold(t, next_pc=d_spawn.pc)

    @m.block
    def d_spawn(sim, p, sig):
        at = None if at_delay is None else api.clock(sim) + at_delay
        sim, pid = api.spawn(sim, clients, at=at, prio=prio)
        sim = spawned(sim, pid)
        if two:
            sim, pid = api.spawn(sim, runners)
            sim = spawned(sim, pid)
        sim = count(sim, "arrivals", 1)
        done = sim.user["arrivals"] >= n_items
        return sim, cmd.select(done, cmd.exit_(), cmd.jump(d_arrive.pc))

    # --- clients: the desk -------------------------------------------------
    @m.block
    def c_start(sim, p, sig):
        sim = api.set_local_f(sim, p, 0, api.clock(sim))
        if fused:
            sim, t = api.draw(sim, cr.exponential, srv_mean)
            return sim, cmd.acquire_hold(desk.id, t, next_pc=c_done.pc)
        return sim, cmd.acquire(desk.id, next_pc=c_serve.pc)

    @m.block
    def c_serve(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, srv_mean)
        return sim, cmd.hold(t, next_pc=c_done.pc)

    @m.block
    def c_done(sim, p, sig):
        u = sim.user
        sim = api.set_user(sim, {**u, "served": u["served"] + 1,
                                 "sum_t": u["sum_t"] + (
                                     api.clock(sim) - api.local_f(sim, p, 0))})
        if inline_release:
            sim = api.release(sim, box[0], desk, p)
            return sim, cmd.exit_()
        return sim, cmd.release(desk.id, next_pc=c_exit.pc)

    @m.block
    def c_exit(sim, p, sig):
        return sim, cmd.exit_()

    # --- runners: a unit of the seats --------------------------------------
    @m.block
    def r_take(sim, p, sig):
        return sim, cmd.pool_acquire(seats.id, 1.0, next_pc=r_hold.pc)

    @m.block
    def r_hold(sim, p, sig):
        sim, t = api.draw(sim, cr.uniform, 0.2, 1.0)
        return sim, cmd.hold(t, next_pc=r_drop.pc)

    @m.block
    def r_drop(sim, p, sig):
        sim = api.pool_release(sim, box[0], seats, p,
                               api.pool_held(sim, seats, p))
        return sim, cmd.exit_()

    # --- the watcher: woken by the desk's releases only --------------------
    @m.block
    def w_wait(sim, p, sig):
        return sim, cmd.cond_wait(free.id, next_pc=w_saw.pc)

    @m.block
    def w_saw(sim, p, sig):
        sim = count(sim, "seen", 1)
        return sim, cmd.hold(0.05, next_pc=w_wait.pc)

    m.process("door", entry=d_burst, prio=rng.choice([0, 2]))
    m.process("watcher", entry=w_wait)
    clients = m.process("client", entry=c_start, count=n_a, start=False)
    runners = (m.process("runner", entry=r_take, count=n_b, start=False)
               if two else None)
    spec = m.build()
    box.append(spec)
    return spec, n_items


def _build_waits(seed: int, lib):
    """The ``waits=True`` family (see the module's docstring)."""
    rng = random.Random(seed)
    Model, api, cmd, cr = lib.Model, lib.api, lib.cmd, lib.cr
    n_work = rng.randint(3, 8)
    arm = rng.choice(["reschedule", "reprioritize", "eager", "lazy",
                      "drain"])
    work_mean = rng.uniform(0.5, 2.0)
    patience = rng.uniform(0.3, 3.0)
    act_at = rng.uniform(0.5, 4.0)
    gated_cancel = rng.random() < 0.5
    with_prio = rng.random() < 0.5
    with_pq = rng.random() < 0.5
    m = Model(f"usergenw{seed}", n_flocals=1, n_ilocals=2, event_cap=16,
              guard_cap=8)
    desk = m.resource("desk", record=rng.random() < 0.5)
    pq = m.priorityqueue("pq", capacity=2, record=rng.random() < 0.5)
    q = m.objectqueue("q", capacity=4, record=False)
    box = []
    stopped_sig, timeout = -3, TIMEOUT

    @m.user_state
    def init(params):
        return {"h": lib.zeros_i() - 1, "joined": lib.zeros_i(),
                "stopped": lib.zeros_i(), "fired": lib.zeros_i(),
                "woke_sig": lib.zeros_i() + 99, "woke_t": lib.real(-1.0),
                "moved": lib.zeros_i(), "pat": lib.zeros_i(),
                "grants": lib.zeros_i(), "timeouts": lib.zeros_i(),
                "freed": lib.zeros_i(), "pos": lib.zeros_i()}

    def count(sim, key, v):
        u = sim.user
        v = v if isinstance(v, int) else lib.i32(v)
        return api.set_user(sim, {**u, key: u[key] + v})

    # --- workers: joined one after another ---------------------------------
    @m.block
    def w_go(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, work_mean)
        t = lib.where(p == 1, 1000.0, t)  # the victim, stopped
        return sim, cmd.select(p == n_work - 1, cmd.exit_(),
                               cmd.hold(t, next_pc=w_end.pc))

    @m.block
    def w_end(sim, p, sig):
        return sim, cmd.exit_()

    # --- the dispatcher ----------------------------------------------------
    @m.block
    def d_go(sim, p, sig):
        return sim, cmd.wait_process(api.local_i(sim, p, 0),
                                     next_pc=d_joined.pc)

    @m.block
    def d_joined(sim, p, sig):
        sim = count(sim, "joined", sig == 0)
        sim = count(sim, "stopped", sig == stopped_sig)
        sim = api.add_local_i(sim, p, 0, 1)
        last = api.local_i(sim, p, 0) >= n_work
        return sim, cmd.select(last, cmd.exit_(), cmd.jump(d_go.pc))

    # --- the watcher and its event -----------------------------------------
    @m.handler
    def on_fire(sim, subj, arg):
        return api.set_user(sim, {**sim.user,
                                  "fired": sim.user["fired"] + 1})

    @m.block
    def v_sched(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, 2.0)
        t = t + (100.0 if arm == "drain" else 1.0)
        sim, h = api.schedule(sim, api.clock(sim) + t, 0, on_fire)
        sim = api.set_user(sim, {**sim.user, "h": h})
        return sim, cmd.wait_event(h, next_pc=v_woke.pc)

    @m.block
    def v_woke(sim, p, sig):
        sim = api.set_user(sim, {**sim.user, "woke_sig": sig,
                                 "woke_t": lib.real_of(api.clock(sim))})
        return sim, cmd.exit_()

    # --- the controller: the victim's stop, the event's move or cancel -----
    @m.block
    def c_go(sim, p, sig):
        return sim, cmd.hold(act_at, next_pc=c_act.pc)

    @m.block
    def c_act(sim, p, sig):
        sim = api.stop_process(sim, box[0], 1)
        h = sim.user["h"]
        if arm == "reschedule":
            sim, ok = api.event_reschedule(sim, h, api.clock(sim) + 2.5)
            sim = count(sim, "moved", ok)
        elif arm == "reprioritize":
            sim, ok = api.event_reprioritize(sim, h, 5)
            sim = count(sim, "moved", ok)
        elif arm == "eager":
            sim, ok = api.event_cancel(sim, h, box[0])
            sim = count(sim, "moved", ok)
        elif arm == "lazy":
            sim, ok = api.timer_cancel(sim, h)
            sim = count(sim, "moved", ok)
        else:  # drain: the lane's last activity, later
            return sim, cmd.hold(60.0, next_pc=c_last.pc)
        return sim, cmd.exit_()

    @m.block
    def c_last(sim, p, sig):
        sim, ok = api.event_cancel(sim, sim.user["h"])
        sim = count(sim, "moved", ok)
        return sim, cmd.exit_()

    # --- a process's timers by pattern -------------------------------------
    @m.block
    def t_go(sim, p, sig):
        sim, _ = api.timer_add(sim, p, 2.0, 8)
        sim, _ = api.timer_add(sim, p, 5.0, 7)
        sim, _ = api.timer_add(sim, p, 9.0, 9)
        return sim, cmd.hold(20.0, next_pc=t_fired.pc)

    @m.block
    def t_fired(sim, p, sig):
        n = api.event_pattern_count(sim, kind=1, subj=p)
        h = api.event_pattern_find(sim, kind=1, subj=p)
        soon = api.event_time(sim, h) == api.clock(sim) + 3.0
        sim, gone = api.event_pattern_cancel(sim, kind=1, subj=p)
        ok = ((sig == 8) & (n == 2) & soon & (gone == 2)
              & (api.event_pattern_count(sim, subj=p) == 0)
              & (api.event_pattern_find(sim, kind=1, subj=p) == -1))
        sim = count(sim, "pat", ok)
        return sim, cmd.exit_()

    # --- an impatient acquirer whose timeout is cancelled on success -------
    @m.block
    def i_go(sim, p, sig):
        sim, h = api.timer_add(sim, p, patience, timeout)
        sim = api.set_local_i(sim, p, 1, h)
        return sim, cmd.acquire(desk.id, next_pc=i_got.pc)

    @m.block
    def i_got(sim, p, sig):
        ok = sig == 0
        sim = count(sim, "grants", ok)
        sim = count(sim, "timeouts", sig == timeout)
        h = api.local_i(sim, p, 1)
        if gated_cancel:
            sim = lib.select_sim(ok, api.timer_cancel(sim, h)[0], sim)
        else:
            sim, _ = api.timer_cancel(sim, h)
        return sim, cmd.select(ok, cmd.hold(0.5, next_pc=i_rel.pc),
                               cmd.exit_())

    @m.block
    def i_rel(sim, p, sig):
        return sim, cmd.release(desk.id, next_pc=w_end.pc)

    @m.block
    def h_go(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, 2.0 * work_mean)
        return sim, cmd.acquire_hold(desk.id, t, next_pc=i_rel.pc)

    # --- a claimant pended on the desk, promoted ---------------------------
    @m.block
    def k_go(sim, p, sig):
        return sim, cmd.hold(0.3, next_pc=k_claim.pc)

    @m.block
    def k_claim(sim, p, sig):
        return sim, cmd.acquire_hold(desk.id, 0.2, next_pc=i_rel.pc)

    @m.block
    def b_go(sim, p, sig):
        return sim, cmd.hold(0.6, next_pc=b_boost.pc)

    @m.block
    def b_boost(sim, p, sig):
        sim = api.priority_set(sim, box[1], 5)
        return sim, cmd.exit_()

    # --- the priority queue's cancel, and the positions --------------------
    @m.block
    def f_go(sim, p, sig):
        return sim, cmd.pq_put(pq.id, 1.0, 0.0, next_pc=f_2.pc)

    @m.block
    def f_2(sim, p, sig):
        return sim, cmd.pq_put(pq.id, 2.0, 0.0, next_pc=f_3.pc)

    @m.block
    def f_3(sim, p, sig):
        return sim, cmd.pq_put(pq.id, 3.0, 0.0, next_pc=f_done.pc)

    @m.block
    def f_done(sim, p, sig):
        sim = count(sim, "freed", 1)
        return sim, cmd.exit_()

    @m.block
    def g_go(sim, p, sig):
        return sim, cmd.hold(1.5, next_pc=g_cancel.pc)

    @m.block
    def g_cancel(sim, p, sig):
        sim, gone = api.pqueue_cancel(sim, pq, 1.0)
        sim, moved = api.pqueue_reprioritize(sim, pq, 2.0, 9.0)
        sim = count(sim, "moved", gone & moved)
        return sim, cmd.put(q.id, 4.0, next_pc=g_look.pc)

    @m.block
    def g_look(sim, p, sig):
        pos = (api.queue_position(sim, q, 4.0) * 10
               + api.pqueue_position(sim, pq, 2.0))
        sim = api.set_local_i(sim, p, 0, pos)
        sim = count(sim, "pos", pos)
        return sim, cmd.exit_()

    m.process("worker", entry=w_go, count=n_work)   # pids 0 .. n_work - 1
    m.process("dispatcher", entry=d_go)
    m.process("watcher", entry=v_sched)
    m.process("controller", entry=c_go, prio=1)
    m.process("timers", entry=t_go)
    m.process("impatient", entry=i_go, prio=1)
    m.process("holder", entry=h_go, prio=2)
    claimant = n_work + 6
    if with_prio:
        m.process("claimant", entry=k_go)            # pid n_work + 6
        m.process("booster", entry=b_go)
    if with_pq:
        m.process("filler", entry=f_go)
        m.process("pq_man", entry=g_go)
    box.append(m.build())
    box.append(claimant)
    return box[0]


def abort_spec(lib):
    """A model whose waits are aborted from outside, every few events:
    two hogs contend for a pool of 4 units; a waiter claims 2.5 under a
    timeout (a timed-out claim rolls its partial grab back, counted in
    ``timeouts``); a consumer's plain buffer get of 3 is interrupted by
    a third process at random times (it keeps its partial take, reported
    in ``got`` and summed in ``partial``) while a producer puts units
    into the buffer.  It runs to a horizon."""
    Model, api, cmd, cr = lib.Model, lib.api, lib.cmd, lib.cr
    m = Model("abort", n_flocals=1, event_cap=8, guard_cap=8)
    pool = m.resourcepool("units", capacity=4.0, record=True)
    buf = m.buffer("tank", capacity=10.0, initial=1.0, record=True)
    box = []

    @m.user_state
    def init(params):
        return {"timeouts": lib.zeros_i(), "grants": lib.zeros_i(),
                "partial": lib.real(0.0), "got_all": lib.zeros_i()}

    # --- hogs: grab 1-3 units, hold, give them back ------------------------
    @m.block
    def h_acq(sim, p, sig):
        sim, a = api.draw(sim, cr.uniform, 1.0, 3.0)
        sim, t = api.draw(sim, cr.exponential, 1.0)
        return sim, cmd.pool_acquire_hold(pool.id, a, t, next_pc=h_rel.pc)

    @m.block
    def h_rel(sim, p, sig):
        sim = api.pool_release(sim, box[0], pool, p,
                               api.pool_held(sim, pool, p))
        sim, t = api.draw(sim, cr.exponential, 0.5)
        return sim, cmd.hold(t, next_pc=h_acq.pc)

    # --- the waiter: a claim of 2.5 under a timeout ------------------------
    @m.block
    def w_acq(sim, p, sig):
        sim, pat = api.draw(sim, cr.uniform, 0.2, 1.2)
        sim, _ = api.timer_add(sim, p, pat, TIMEOUT)
        return sim, cmd.pool_acquire(pool.id, 2.5, next_pc=w_got.pc)

    @m.block
    def w_got(sim, p, sig):
        ok = sig == 0
        u = sim.user
        sim = api.set_user(sim, {
            **u, "timeouts": u["timeouts"] + lib.i32(lib.where(ok, 0, 1)),
            "grants": u["grants"] + lib.i32(lib.where(ok, 1, 0))})
        sim = lib.select_sim(ok, api.timers_clear(sim, p), sim)
        return sim, cmd.select(ok, cmd.hold(0.5, next_pc=w_rel.pc),
                               cmd.hold(0.25, next_pc=w_acq.pc))

    @m.block
    def w_rel(sim, p, sig):
        sim = api.pool_release(sim, box[0], pool, p,
                               api.pool_held(sim, pool, p))
        return sim, cmd.jump(w_acq.pc)

    # --- the buffer's consumer, producer and interrupter -------------------
    @m.block
    def b_get(sim, p, sig):
        return sim, cmd.buffer_get(buf.id, 3.0, next_pc=b_got.pc)

    @m.block
    def b_got(sim, p, sig):
        whole = sig == 0
        u = sim.user
        sim = api.set_user(sim, {
            **u, "got_all": u["got_all"] + lib.i32(lib.where(whole, 1, 0)),
            "partial": u["partial"] + lib.where(whole, 0.0,
                                                 api.got(sim, p))})
        return sim, cmd.hold(0.1, next_pc=b_get.pc)

    @m.block
    def b_put(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, 0.8)
        return sim, cmd.buffer_put_hold(buf.id, 1.0, t, next_pc=b_put.pc)

    @m.block
    def poke(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, 2.0)
        sim = api.interrupt(sim, box[0], 3, INTERRUPTED)
        return sim, cmd.hold(t, next_pc=poke.pc)

    m.process("hog", entry=h_acq, count=2)   # pids 0, 1
    m.process("waiter", entry=w_acq)         # pid 2
    m.process("consumer", entry=b_get)       # pid 3
    m.process("producer", entry=b_put)       # pid 4
    m.process("poker", entry=poke)           # pid 5
    spec = m.build()
    box.append(spec)
    return spec


#: spawn_mm1_spec's customers, and its pool's rows
SPAWN_MM1_CUSTOMERS, SPAWN_MM1_POOL = 30, 8


def spawn_mm1_spec(lib):
    """The per-customer M/M/1 of spawn pools (the reference's
    ``tests/test_spawn.py`` ``_build``), 9 processes: an arrival process
    spawns one customer process per arrival from a pool of
    SPAWN_MM1_POOL rows; a customer stamps its birth in its float local,
    checks that the local was zeroed, takes the server (a binary
    resource), holds, releases it, zeroes its local and exits, so its row
    is recycled.  ``order_ok`` holds while service follows birth order
    and every spawned row's local starts at zero.  Every lane ends, by
    ``api.stop`` once SPAWN_MM1_CUSTOMERS are done."""
    Model, api, cmd, cr = lib.Model, lib.api, lib.cmd, lib.cr
    n = SPAWN_MM1_CUSTOMERS
    m = Model("spawnmm1", n_flocals=1, n_ilocals=1, event_cap=16)
    srv = m.resource("server", record=False)

    @m.user_state
    def init(params):
        return {"spawned": lib.zeros_i(), "done": lib.zeros_i(),
                "sum_t": lib.real(0.0), "misses": lib.zeros_i(),
                "last_start": lib.real(-1.0),
                "order_ok": lib.zeros_i() == 0}

    @m.block
    def arrive(sim, p, sig):
        fin = sim.user["spawned"] >= n
        sim, t = api.draw(sim, cr.exponential, 1.0)
        return sim, cmd.select(fin, cmd.exit_(),
                               cmd.hold(t, next_pc=a_spawn.pc))

    @m.block
    def a_spawn(sim, p, sig):
        sim, pid = api.spawn(sim, customers)
        ok = pid >= 0
        u = sim.user
        sim = api.set_user(sim, {
            **u, "spawned": u["spawned"] + lib.i32(ok),
            "misses": u["misses"] + lib.i32(~ok)})
        return sim, cmd.jump(arrive.pc)

    @m.block
    def c_start(sim, p, sig):
        zeroed = api.local_f(sim, p, 0) == 0.0
        sim = api.set_user(
            sim, {**sim.user, "order_ok": sim.user["order_ok"] & zeroed})
        sim = api.set_local_f(sim, p, 0, api.clock(sim))
        return sim, cmd.acquire(srv.id, next_pc=c_serve.pc)

    @m.block
    def c_serve(sim, p, sig):
        u = sim.user
        birth = api.local_f(sim, p, 0)
        sim = api.set_user(sim, {
            **u, "order_ok": u["order_ok"] & (birth >= u["last_start"]),
            "last_start": birth})
        sim, t = api.draw(sim, cr.exponential, 0.8)
        return sim, cmd.hold(t, next_pc=c_done.pc)

    @m.block
    def c_done(sim, p, sig):
        u = sim.user
        t_sys = api.clock(sim) - api.local_f(sim, p, 0)
        sim = api.set_user(sim, {**u, "done": u["done"] + 1,
                                 "sum_t": u["sum_t"] + t_sys})
        sim = api.stop(sim, u["done"] + 1 >= n)
        sim = api.set_local_f(sim, p, 0, 0.0)
        return sim, cmd.release(srv.id, next_pc=c_exit.pc)

    @m.block
    def c_exit(sim, p, sig):
        return sim, cmd.exit_()

    m.process("arrival", entry=arrive, prio=1)
    customers = m.process("customer", entry=c_start,
                          count=SPAWN_MM1_POOL, start=False)
    return m.build()


#: wait_event_spec's horizon: a process exits at its first wake past it
WAITEV_T_DONE = 6.0


def wait_event_spec(lib):
    """The reference's kernel-path model of ``cmd.wait_event``
    (``tests/test_wait_event.py``, ``test_wait_event_model_through_kernel``),
    its constants unchanged: three ``sched`` processes each schedule a
    user event (``on_fire``, which counts ``fires``) at an exponential
    delay of mean 1, wait on its handle, record the wake's signal and
    time in their locals and hold 0.1, until the clock passes
    WAITEV_T_DONE.  Every lane ends: each process exits."""
    Model, api, cmd, cr = lib.Model, lib.api, lib.cmd, lib.cr
    m = Model("waitev", n_flocals=2, n_ilocals=2, event_cap=16)

    @m.user_state
    def init(params):
        return {"fires": lib.zeros_i()}

    @m.handler
    def on_fire(sim, subj, arg):
        return api.set_user(sim, {**sim.user,
                                  "fires": sim.user["fires"] + 1})

    @m.block
    def s_go(sim, p, sig):
        sim, dt = api.draw(sim, cr.exponential, 1.0)
        sim, h = api.schedule(sim, api.clock(sim) + dt, 0, on_fire)
        sim = api.set_local_i(sim, p, 1, h)
        return sim, cmd.wait_event(h, next_pc=s_woke.pc)

    @m.block
    def s_woke(sim, p, sig):
        sim = api.set_local_i(sim, p, 0, sig)
        sim = api.set_local_f(sim, p, 0, api.clock(sim))
        done = api.clock(sim) > WAITEV_T_DONE
        return sim, cmd.select(done, cmd.exit_(),
                               cmd.hold(0.1, next_pc=s_go.pc))

    m.process("sched", entry=s_go, count=3)
    return m.build()


def fail_spec(lib):
    """The failure semantics of the logger and the assertion tiers: a
    ``checker`` that counts its wakes at exponential intervals of mean 1
    and fails its lane by ``dbc.assert_always`` at its fifth; an
    ``errer`` that waits an exponential of mean 2 and calls
    ``logger.error``; a ``fataler`` that waits one of mean 3 and calls
    ``logger.fatal``.  Whichever comes first fails the lane with
    ``ERR_USER`` and freezes it, so every lane ends failed.  Traced for
    the generated chunk kernel with the error and fatal levels on, the
    two calls keep the failure flag, drop their lines and warn."""
    Model, api, cmd, cr = lib.Model, lib.api, lib.cmd, lib.cr
    logger, dbc = lib.logger, lib.dbc
    m = Model("failgen", n_ilocals=1, event_cap=8)

    @m.block
    def c_tick(sim, p, sig):
        n = api.local_i(sim, p, 0)
        sim = api.add_local_i(sim, p, 0, 1)
        sim = dbc.assert_always(sim, n < 4)
        sim, dt = api.draw(sim, cr.exponential, 1.0)
        return sim, cmd.hold(dt, next_pc=c_tick.pc)

    @m.block
    def e_wait(sim, p, sig):
        sim, dt = api.draw(sim, cr.exponential, 2.0)
        return sim, cmd.hold(dt, next_pc=e_boom.pc)

    @m.block
    def e_boom(sim, p, sig):
        sim = logger.error(sim, p, "boom at t={0}", api.clock(sim))
        return sim, cmd.exit_()

    @m.block
    def f_wait(sim, p, sig):
        sim, dt = api.draw(sim, cr.exponential, 3.0)
        return sim, cmd.hold(dt, next_pc=f_die.pc)

    @m.block
    def f_die(sim, p, sig):
        sim = logger.fatal(sim, p, "unrecoverable n={0}",
                           api.local_i(sim, p, 0))
        return sim, cmd.exit_()

    m.process("checker", entry=c_tick)
    m.process("errer", entry=e_wait)
    m.process("fataler", entry=f_wait)
    return m.build()


def sweep_spec(lib):
    """The reference sweep tests' one-block model (``tests/test_sweep.py``,
    ``_sweep_spec``): one process draws an exponential of mean
    ``step_mean`` and holds it, each draw a sample of the ``wait``
    summary, until ``n_steps`` samples; the run's parameters are
    ``(step_mean, n_steps)``, a sweep grid's row.  Every lane ends, by
    ``api.stop``."""
    Model, api, cmd, cr = lib.Model, lib.api, lib.cmd, lib.cr
    m = Model("tinysweep", event_cap=1, guard_cap=2)

    @m.user_state
    def ui(params):
        step_mean, n_steps = params
        return {"step_mean": lib.real_of(step_mean),
                "n_steps": lib.i32(n_steps), "wait": lib.empty()}

    @m.block
    def work(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, sim.user["step_mean"])
        wait = lib.add(sim.user["wait"], t)
        sim = api.set_user(sim, {**sim.user, "wait": wait})
        sim = api.stop(sim, wait.n >= lib.real_of(sim.user["n_steps"]))
        return sim, cmd.hold(t, next_pc=work.pc)

    m.process("w", entry=work)
    return m.build()


def fuse_spec(lib, i: int, t_stop: float = 12.0):
    """Member ``i`` of the reference's wave-fusion class
    (``tests/test_fuse.py``, ``_fz_spec``; ``bench.py``'s
    ``bench_serve_fused``): one process holding ``0.5 + 0.25 i`` until its
    clock passes ``t_stop``, then exiting.  Members differ only in the
    hold, a trace-time constant, so they share one fusion shape and each
    is a model of its own."""
    # the block closes over functions, not modules, so the spec has a
    # value fingerprint (serve.cache.fusion_order_key orders by it)
    clock, select, exit_, hold = (lib.api.clock, lib.cmd.select,
                                  lib.cmd.exit_, lib.cmd.hold)
    step = 0.5 + 0.25 * i
    m = lib.Model(f"fz{i}", event_cap=1, guard_cap=2)

    @m.block
    def work(sim, p, sig):
        done = clock(sim) > t_stop
        return sim, select(done, exit_(), hold(step, next_pc=work.pc))

    m.process("w", entry=work)
    return m.build()


def wait_process_spec(lib, joins: bool = False):
    """The reference's scripted ``cmd.wait_process`` models
    (``tests/test_toolkit.py``).  Without ``joins``,
    ``test_wait_process_mass_wake_preserves_pid_order``: a target holds 5
    and exits, and its exit wakes three waiters in pid order; each waiter
    records its place in that order in its integer local (the reference
    writes the pids into a user array of 4, which the generated kernel
    does not take: a user leaf is one value a lane).  With ``joins``,
    ``test_wait_process_success_and_stopped``: a worker exits at 5 and a
    victim holding 50 is stopped at 3 by a killer; one waiter joins each
    and records the wake's time and signal (SUCCESS at 5, STOPPED at 3)
    in its float locals."""
    Model, api, cmd = lib.Model, lib.api, lib.cmd
    if not joins:
        m = Model("masswake", n_ilocals=1, event_cap=8, guard_cap=4)

        @m.user_state
        def init(params):
            return {"k": lib.zeros_i()}

        @m.block
        def target(sim, p, sig):
            return sim, cmd.hold(5.0, next_pc=t_exit.pc)

        @m.block
        def t_exit(sim, p, sig):
            return sim, cmd.exit_()

        @m.block
        def waiter(sim, p, sig):
            return sim, cmd.wait_process(0, next_pc=woke.pc)

        @m.block
        def woke(sim, p, sig):
            k = sim.user["k"]
            sim = api.set_local_i(sim, p, 0, k)
            sim = api.set_user(sim, {**sim.user, "k": k + 1})
            return sim, cmd.exit_()

        m.process("target", entry=target)
        m.process("waiter", entry=waiter, count=3)
        return m.build()

    m = Model("waitp", n_flocals=2, event_cap=16, guard_cap=4)
    box = []

    @m.block
    def worker(sim, p, sig):
        return sim, cmd.hold(5.0, next_pc=worker_done.pc)

    @m.block
    def worker_done(sim, p, sig):
        return sim, cmd.exit_()

    @m.block
    def victim(sim, p, sig):
        return sim, cmd.hold(50.0, next_pc=worker_done.pc)

    @m.block
    def waiter1(sim, p, sig):
        return sim, cmd.wait_process(0, next_pc=w1done.pc)

    @m.block
    def w1done(sim, p, sig):
        sim = api.set_local_f(sim, p, 0, api.clock(sim))
        sim = api.set_local_f(sim, p, 1, lib.real_of(sig))
        return sim, cmd.exit_()

    @m.block
    def waiter2(sim, p, sig):
        return sim, cmd.wait_process(1, next_pc=w1done.pc)

    @m.block
    def killer(sim, p, sig):
        return sim, cmd.hold(3.0, next_pc=kill.pc)

    @m.block
    def kill(sim, p, sig):
        sim = api.stop_process(sim, box[0], 1)
        return sim, cmd.exit_()

    m.process("worker", entry=worker)    # pid 0
    m.process("victim", entry=victim)    # pid 1
    m.process("waiter1", entry=waiter1)  # pid 2
    m.process("waiter2", entry=waiter2)  # pid 3
    m.process("killer", entry=killer)    # pid 4
    box.append(m.build())
    return box[0]
