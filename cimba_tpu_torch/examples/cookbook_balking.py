"""The balking M/M/1 of the manual's cookbook (torch restatement of
``examples/cookbook_balking.py``): customers balk at a long line and
renege (lazily) after their patience expires.

The blocks, draws, constants and dtypes are the reference's, line for
line; the blocks act on every replication lane at once.  Where the
reference adds ``jnp.where(balk, 1, 0)`` (weakly typed) to an int32
count, the restatement casts to ``INDEX``, which keeps the count int32
as JAX does.  The user state's parameters keep the dtype the reference
gives them (``jnp.asarray`` of a Python float is float64 in both
profiles).
"""

from __future__ import annotations

import torch

import cimba_tpu_torch.random as cr
from cimba_tpu_torch import config
from cimba_tpu_torch.config import INDEX
from cimba_tpu_torch.core import api
from cimba_tpu_torch.core import process as cmd
from cimba_tpu_torch.core.model import Model
from cimba_tpu_torch.stats import summary as sm

BALK_LEN = 5
SIG_RENEGE = 100
L_DONE = 0


def build():
    """Returns ``(spec, queue ref)``."""
    m = Model("balking_mm1", n_ilocals=1, event_cap=16, guard_cap=8)
    q = m.objectqueue("line", capacity=64, record=False)

    @m.user_state
    def init(params):
        arr_mean, srv_mean, patience, n_customers = params
        zeros = torch.zeros(arr_mean.shape, dtype=INDEX,
                            device=arr_mean.device)
        return {
            "arr_mean": arr_mean.to(torch.float64),
            "srv_mean": srv_mean.to(torch.float64),
            "patience": patience.to(torch.float64),
            "n_customers": n_customers.to(INDEX),
            "balked": zeros,
            "reneged": zeros.clone(),
            "wait": sm.empty(arr_mean.shape, arr_mean.device,
                             config.real()),
        }

    # --- arrival process: one generator spawning "virtual" customers ---
    @m.block
    def a_hold(sim, p, sig):
        n = api.local_i(sim, p, L_DONE)
        finished = n >= sim.user["n_customers"]
        sim, t = api.draw(sim, cr.exponential, sim.user["arr_mean"])
        return sim, cmd.select(
            finished, cmd.exit_(), cmd.hold(t, next_pc=a_join.pc)
        )

    @m.block
    def a_join(sim, p, sig):
        sim = api.add_local_i(sim, p, L_DONE, 1)
        balk = api.queue_length(sim, q) >= BALK_LEN
        sim = api.set_user(
            sim,
            {**sim.user,
             "balked": sim.user["balked"]
             + torch.where(balk, 1, 0).to(INDEX)},
        )
        join = cmd.put(q.id, api.clock(sim), next_pc=a_hold.pc)
        return sim, cmd.select(balk, cmd.jump(a_hold.pc), join)

    # --- server ---
    @m.block
    def s_get(sim, p, sig):
        return sim, cmd.get(q.id, next_pc=s_serve.pc)

    @m.block
    def s_serve(sim, p, sig):
        # renege check: customers whose wait already exceeds patience
        # leave unserved
        waited = api.clock(sim) - api.got(sim, p)
        gone = waited > sim.user["patience"]
        sim = api.set_user(
            sim,
            {**sim.user,
             "reneged": sim.user["reneged"]
             + torch.where(gone, 1, 0).to(INDEX)},
        )
        sim, t = api.draw(sim, cr.exponential, sim.user["srv_mean"])
        return sim, cmd.select(
            gone, cmd.jump(s_get.pc), cmd.hold(t, next_pc=s_done.pc)
        )

    @m.block
    def s_done(sim, p, sig):
        t_sys = api.clock(sim) - api.got(sim, p)
        sim = api.set_user(
            sim, {**sim.user, "wait": sm.add(sim.user["wait"], t_sys)}
        )
        done = (sim.user["wait"].n
                + sim.user["balked"] + sim.user["reneged"]
                >= sim.user["n_customers"])
        sim = api.stop(sim, done)
        return sim, cmd.jump(s_get.pc)

    m.process("arrival", entry=a_hold, prio=0)
    m.process("server", entry=s_get, prio=0)
    return m.build(), q


def params(n_customers: int = 2000):
    """The reference's ``(arr_mean, srv_mean, patience, n_customers)``."""
    return (1 / 0.9, 1.0, 8.0, n_customers)


def summary_path(sims):
    """The pooled statistic: the served customers' sojourn times."""
    return sims.user["wait"]
