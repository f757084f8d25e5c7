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
        where=torch.where, empty=lambda: sm.empty((), "cpu"), add=sm.add)


def build(seed: int, lib):
    """One random spec; returns ``(spec, n_items)``."""
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

    m = Model(f"usergen{seed}", n_flocals=1, n_ilocals=1, event_cap=8,
              guard_cap=8)
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
        return {"done_n": lib.zeros_i(), "watched": lib.zeros_i(),
                "srv_mean": lib.real(srv_mean), "w": lib.empty()}

    # --- producer: n_items items into q ----------------------------------
    @m.block
    def produce(sim, p, sig):
        made = api.local_i(sim, p, 0)
        fin = made >= n_items
        sim = api.add_local_i(sim, p, 0, 1)
        sim, t = api.draw(sim, cr.exponential, arr_mean)
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
            return sim, cmd.get_hold(q.id, t, next_pc=c_acq.pc)
        return sim, cmd.get(q.id, next_pc=c_acq.pc)

    @m.block
    def c_acq(sim, p, sig):
        sim, u = api.draw(sim, cr.triangular, 0.0, 0.3, 1.0)
        sim, t = api.draw(sim, cr.lognormal, -0.5, 0.4)
        use_b = u < 0.5
        return sim, cmd.select(
            use_b, cmd.pool_acquire_hold(pb.id, 1.0, t, next_pc=c_put.pc),
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
        return sim, cmd.hold(1.0, next_pc=w_arm.pc)

    m.process("producer", entry=produce)
    m.process("consumer", entry=c_get, count=n_cons)
    m.process("drain", entry=d_get)
    m.process("watcher", entry=w_arm, prio=1)
    spec = m.build()
    box.append(spec)
    return spec, n_items
