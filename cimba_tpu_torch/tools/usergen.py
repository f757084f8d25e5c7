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

    return types.SimpleNamespace(
        Model=Model, api=api, cmd=cmd, cr=cr,
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
          spawn: bool = False):
    """One random spec; returns ``(spec, n_items)`` (``n_items`` None for
    a ``resources`` spec; the door's arrivals for a ``spawn`` one)."""
    if resources:
        return _build_resources(seed, lib), None
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
