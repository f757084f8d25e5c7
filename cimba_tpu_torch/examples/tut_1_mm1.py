"""Tutorial 1 — a simple M/M/1 queue, parallelized (torch restatement of
``examples/tut_1_mm1.py``, itself the reference's ``tutorial/tut_1_*.c``).

1.  **Model**: an arrival process puts customers into a buffer at
    exp(1/lambda) intervals; a service process takes them out and holds
    exp(1/mu).  Customers are indistinguishable, so a fungible buffer,
    not an object queue, holds them, as in the reference.
2.  **Recording**: the buffer records its level over time; the
    time-average queue length comes out of its step accumulator.
3.  **Experiment**: replications are the lanes of one batched Sim, run
    through ``run_experiment`` (on the card, a generated instance of the
    CUDA chunk kernel), pooled with a normal confidence interval.
    Theory: Lq = rho^2 / (1 - rho).

Run:  python -m cimba_tpu_torch.examples.tut_1_mm1

Observability: ``CIMBA_TRACE=1`` re-runs a 2-replication slice with the
flight recorder and the metrics registry on and exports a Chrome-trace /
Perfetto JSON (path ``CIMBA_TRACE_OUT``, default ``trace_tut1.json``).
The CUDA chunk kernel carries neither, so the slice runs on the plain
engine (``core.loop.make_run``), on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import os

import torch

import cimba_tpu_torch.random as cr
from cimba_tpu_torch import tree
from cimba_tpu_torch.core import api
from cimba_tpu_torch.core import process as cmd
from cimba_tpu_torch.core.model import Model
from cimba_tpu_torch.stats import summary as sm
from cimba_tpu_torch.stats import timeseries as ts

RHO = 0.9          # offered load lambda/mu
T_END = 800.0      # horizon a replication
R = 32             # replications (the reference's 100 pthread trials)
SEED = 2026


def build():
    m = Model("tut1", event_cap=16)
    queue = m.buffer("customers", capacity=10_000.0, record=True)

    @m.user_state
    def init(params):
        return {"arr_mean": torch.tensor(1.0 / RHO, dtype=torch.float64),
                "srv_mean": torch.tensor(1.0, dtype=torch.float64)}

    # -- the two processes ----------------------------------------------
    @m.block
    def a_hold(sim, p, sig):
        sim, dt = api.draw(sim, cr.exponential, sim.user["arr_mean"])
        return sim, cmd.hold(dt, next_pc=a_put.pc)

    @m.block
    def a_put(sim, p, sig):
        # one indistinguishable customer joins the queue
        return sim, cmd.buffer_put(queue.id, 1.0, next_pc=a_hold.pc)

    @m.block
    def s_get(sim, p, sig):
        return sim, cmd.buffer_get(queue.id, 1.0, next_pc=s_hold.pc)

    @m.block
    def s_hold(sim, p, sig):
        sim, dt = api.draw(sim, cr.exponential, sim.user["srv_mean"])
        return sim, cmd.hold(dt, next_pc=s_get.pc)

    m.process("arrival", entry=a_hold)
    m.process("service", entry=s_get)
    return m.build(), queue


def main(R: int = R, t_end: float = T_END, device="cuda"):
    from cimba_tpu_torch.runner import experiment

    spec, queue = build()
    res = experiment.run_experiment(spec, None, R, seed=SEED, t_end=t_end,
                                    device=device)
    out = res.sims
    assert int(res.n_failed) == 0, "replications failed"
    # time-average queue length from the buffer's step recording
    acc = tree.map(lambda x: x[:, queue.id], out.buffers.acc)
    per_rep = sm.mean(ts.step_finalize(acc, out.clock))
    n = per_rep.shape[0]
    mean = float(per_rep.mean())
    half = float(1.96 * per_rep.std() / n ** 0.5)
    theory = RHO * RHO / (1.0 - RHO)
    print(f"replications      : {n} x {t_end:.0f} time units")
    print(f"mean queue length : {mean:.3f} ± {half:.3f} (95% CI)")
    print(f"M/M/1 theory  Lq  : {theory:.3f}")
    # short-horizon averages are biased low (the queue starts empty), so
    # the gate is statistical: within 3 CI half-widths or 25%
    assert abs(mean - theory) < max(3 * half, 0.25 * theory), (
        mean, theory, half)
    if os.environ.get("CIMBA_TRACE"):
        traced_run(device=device)
    return mean, half


def traced_run(device="cuda", out_path=None):
    """The observability pass: the same model, 2 replications to t=40,
    with the flight recorder and the metrics registry on, exported as
    Chrome-trace JSON.  The chunk kernel refuses both, so this runs the
    plain engine on ``device``.  Returns ``(sims, spec, doc)``."""
    from cimba_tpu_torch.core import loop
    from cimba_tpu_torch.obs import export as oe
    from cimba_tpu_torch.obs import metrics as om
    from cimba_tpu_torch.obs import trace as ot

    ot.enable(512)
    om.enable()
    try:
        spec, _ = build()  # a fresh spec: the obs state binds at init
        sims = loop.make_run(spec, t_end=40.0)(loop.init_sim(
            spec, SEED, torch.arange(2), device=device))
        out_path = out_path or os.environ.get("CIMBA_TRACE_OUT",
                                              "trace_tut1.json")
        doc = oe.dump_chrome_trace(out_path, sims, spec)
        oe.validate_chrome_trace(doc)
        print(f"flight recorder   : {doc['otherData']['recorded_events']} "
              f"events from 2 replications -> {out_path}")
        print(f"metrics           : {doc['otherData']['metrics']}")
    finally:
        ot.disable()
        om.disable()
    return sims, spec, doc


if __name__ == "__main__":
    main()
