"""Tutorial 3, M/G/c with balking, reneging and jockeying visitors (torch
restatement of ``examples/tut_3_balking.py``, itself the reference's
``tutorial/tut_3_1.c``).

Visitors join the shorter of two priority queues, balk when it is too
long, renege on a patience timer and jockey to the other queue when
their place there is worth it; a server per queue serves them and ends
each service with an ``api.interrupt`` of the visitor.  The blocks,
draws, constants and dtypes are the reference's, line for line; the
blocks act on every replication lane at once.  Where the reference keeps
or drops a call's effect by selecting between the whole Sim before and
after it (``jax.tree.map(lambda a, b: jnp.where(pred, a, b), ...)``),
the restatement does the same lane by lane with :func:`_where_sim`.
A ticket is ``pid + generation / 1024`` in float64, as the reference's.
"""

from __future__ import annotations

import torch

import cimba_tpu_torch.random as cr
from cimba_tpu_torch import tree
from cimba_tpu_torch.config import INDEX
from cimba_tpu_torch.core import api
from cimba_tpu_torch.core import process as cmd
from cimba_tpu_torch.core.model import Model

N_VISITORS = 8
N_VISITS = 4          # rides each visitor attempts before leaving
BALK_LEN = 5          # join only if the shortest queue is below this
RENEGE_AFTER = 6.0    # patience while queued
JOCKEY_AFTER = 2.0    # reconsider the other queue after this long
SIG_SERVED = 100
SIG_JOCKEY = 101
SIG_RENEGE = 102
T_END = 400.0
SEED = 11

# visitor ilocals
LI_TICKET = 0   # current ticket generation (stale entries are ghosts)
LI_VISITS = 1   # rides completed
LI_BALKED = 2
LI_RENEGED = 3
LI_TRIES = 4    # attempts started
LI_QUEUE = 5    # which queue I am (logically) in


def _ticket(p, gen):
    """Encode (pid, generation) into a float64 payload."""
    return p.to(torch.float64) + gen.to(torch.float64) / 1024.0


def _where_sim(pred, a, b):
    """``pred ? a : b`` leaf by leaf, lane by lane (the reference's
    ``jax.tree.map(lambda a, b: jnp.where(pred, a, b), a, b)`` under
    ``vmap``); a leaf both sides share passes through."""
    def sel(x, y):
        if x is y:
            return x
        return torch.where(pred.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)

    return tree.map(sel, a, b)


def _decode(ticket):
    """(visitor pid, ticket generation) of a payload."""
    vid = torch.floor(ticket).to(INDEX)
    gen = torch.round((ticket - torch.floor(ticket)) * 1024.0).to(INDEX)
    return vid, gen


def build():
    m = Model("park3", n_ilocals=6, event_cap=96, guard_cap=32)
    q0 = m.priorityqueue("line0", capacity=64, record=False)
    q1 = m.priorityqueue("line1", capacity=64, record=False)
    spec_box = []

    @m.user_state
    def init(params):
        return {"served": torch.zeros((), dtype=INDEX)}

    # ---- visitors ----------------------------------------------------
    @m.block
    def v_walk(sim, p, sig):
        done = api.local_i(sim, p, LI_TRIES) >= N_VISITS
        sim = api.add_local_i(sim, p, LI_TRIES, 1)
        sim, dt = api.draw(sim, cr.pert, 0.5, 1.0, 2.0)
        return sim, cmd.select(done, cmd.exit_(),
                               cmd.hold(dt, next_pc=v_join.pc))

    @m.block
    def v_join(sim, p, sig):
        len0 = api.pqueue_length(sim, q0)
        len1 = api.pqueue_length(sim, q1)
        shortest = torch.where(len1 < len0, 1, 0)
        shortlen = torch.minimum(len0, len1)
        balk = shortlen >= BALK_LEN
        sim = api.add_local_i(sim, p, LI_BALKED, torch.where(balk, 1, 0))
        # two timers on join, only when actually joining
        simj, _ = api.timer_add(sim, p, JOCKEY_AFTER, SIG_JOCKEY)
        simj, _ = api.timer_add(simj, p, RENEGE_AFTER, SIG_RENEGE)
        simj = api.set_local_i(simj, p, LI_QUEUE, shortest)
        sim = _where_sim(balk, sim, simj)
        gen = api.local_i(sim, p, LI_TICKET)
        qid = torch.where(shortest == 1, q1.id, q0.id)
        join = cmd.pq_put(qid, _ticket(p, gen), 0.0, next_pc=v_suspend.pc)
        return sim, cmd.select(balk, cmd.jump(v_walk.pc), join)

    @m.block
    def v_suspend(sim, p, sig):
        # the queue is never full at these sizes: the put completed; wait
        # for the server (or a timer)
        return sim, cmd.hold(1e9, next_pc=v_signal.pc)

    @m.block
    def v_signal(sim, p, sig):
        served = sig == SIG_SERVED
        renege = sig == SIG_RENEGE
        jockey = sig == SIG_JOCKEY

        sim = api.add_local_i(sim, p, LI_VISITS, torch.where(served, 1, 0))
        sim = api.add_local_i(sim, p, LI_RENEGED, torch.where(renege, 1, 0))
        # leaving (served or reneged): invalidate my ticket so a queued
        # ghost is skipped, clear the other timer, walk on
        sim = api.add_local_i(sim, p, LI_TICKET,
                              torch.where(served | renege, 1, 0))
        leave = served | renege

        # jockeying: is the other queue shorter than my position here?
        me_q = api.local_i(sim, p, LI_QUEUE)
        gen = api.local_i(sim, p, LI_TICKET)
        my_pos = torch.where(
            me_q == 1,
            api.pqueue_position(sim, q1, _ticket(p, gen)),
            api.pqueue_position(sim, q0, _ticket(p, gen)),
        )
        other_len = torch.where(me_q == 1, api.pqueue_length(sim, q0),
                                api.pqueue_length(sim, q1))
        move = jockey & (other_len + 1 < my_pos)
        # move = ghost the old ticket, join the other line with a new one
        sim = api.add_local_i(sim, p, LI_TICKET, torch.where(move, 1, 0))
        new_gen = api.local_i(sim, p, LI_TICKET)
        new_q = 1 - me_q
        sim = api.set_local_i(sim, p, LI_QUEUE,
                              torch.where(move, new_q, me_q))
        requeue = cmd.pq_put(
            torch.where(new_q == 1, q1.id, q0.id),
            _ticket(p, new_gen),
            1.0,  # the reference rejoins at priority+1
            next_pc=v_suspend.pc,
        )
        sim2 = api.timers_clear(sim, p)
        return (
            _where_sim(leave, sim2, sim),
            cmd.select(
                leave,
                cmd.jump(v_walk.pc),
                cmd.select(move, requeue, cmd.hold(1e9,
                                                   next_pc=v_signal.pc)),
            ),
        )

    # ---- servers (one per line) --------------------------------------
    def make_server(q):
        @m.block
        def s_get(sim, p, sig):
            return sim, cmd.pq_get(q.id, next_pc=s_serve.pc)

        @m.block
        def s_serve(sim, p, sig):
            vid, gen = _decode(api.got(sim, p))
            live = gen == api.local_i(sim, vid, LI_TICKET)
            # a ghost ticket (reneged or jockeyed away): skip, no service
            sim, dt = api.draw(sim, cr.lognormal, 0.0, 0.5)  # the G
            return sim, cmd.select(live, cmd.hold(dt, next_pc=s_done.pc),
                                   cmd.jump(s_get.pc))

        @m.block
        def s_done(sim, p, sig):
            vid, gen = _decode(api.got(sim, p))
            live = gen == api.local_i(sim, vid, LI_TICKET)
            sim2 = api.interrupt(sim, spec_box[0], vid, SIG_SERVED)
            sim2 = api.set_user(sim2, {**sim2.user,
                                       "served": sim2.user["served"] + 1})
            sim = _where_sim(live, sim2, sim)
            return sim, cmd.jump(s_get.pc)

        return s_get

    s0 = make_server(q0)
    s1 = make_server(q1)

    m.process("visitor", entry=v_walk, prio=0, count=N_VISITORS)
    m.process("server0", entry=s0, prio=1)
    m.process("server1", entry=s1, prio=1)
    spec = m.build()
    spec_box.append(spec)
    return spec


def params():
    """The tutorial takes no parameters."""
    return None


def run(R: int, device="cuda", seed: int = SEED, t_end: float = T_END):
    """``R`` replications through ``runner.experiment.run_experiment``
    (the card unless ``device="cpu"``)."""
    from cimba_tpu_torch.runner import experiment

    return experiment.run_experiment(build(), params(), R, seed=seed,
                                     t_end=t_end, device=device)
