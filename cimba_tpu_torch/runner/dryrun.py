"""The multi-device dry run (torch port of :mod:`cimba_tpu.runner.dryrun`).

Replications shard over the mesh's ``rep`` axis (a discrete-event
simulator's data parallelism): each shard's Pébay partial moves to the
mesh's first device and the partials merge there, the counters sum.
The arms, on an ``n_devices`` mesh:

* the sharded experiment (``make_sharded_experiment``), mm1 at 32
  replications a shard x 50 objects, seed 1; at 8 shards in the f64
  profile its pooled mean is the reference's golden value;
* the stream over the mesh (``run_experiment_stream(mesh=)``), whose
  event count and pooled statistics match the sharded experiment's;
* the kernel arm: mm1's chunks sharded (K1 on the card), every lane's
  event count and clock equal to the unsharded run's, in f32;
* the serve arm: three threaded clients of a ``serve.Service`` over the
  mesh (two compatible requests packed into one sharded wave, a third
  with another seed), each bitwise its direct mesh stream through the
  shared program cache;
* the AWACS arm: the AWACS chunks and their boundary rounds (the dwell,
  K5 fused, on the card) sharded, held the same way.

On ``device="cuda"`` the mesh is ``make_mesh(n_devices)`` (one card a
shard) unless ``mesh=`` gives another (two shards on one card, say); on
``device="cpu"`` it is ``n_devices`` virtual shards on the CPU.

Run:  python -m cimba_tpu_torch.runner.dryrun [N] [cpu]
"""

from __future__ import annotations

#: the pooled mean sojourn of the canonical configuration (f64, seed 1,
#: 256 replications x 50 objects over 8 shards): the reference's
#: ``dryrun.py`` golden, which its sharded experiment meets
GOLDEN_MEAN_8 = 4.112945867223963


def run_dryrun(n_devices: int, device="cuda", mesh=None) -> dict:
    """Every arm over an ``n_devices`` mesh; raises AssertionError on a
    check that fails, prints the summary line and returns each arm's
    event count."""
    from cimba_tpu_torch.models import mm1
    from cimba_tpu_torch.runner import experiment as ex
    from cimba_tpu_torch.stats import summary as sm

    if mesh is None:
        mesh = ex.make_mesh(n_devices, device=device)
    if mesh.size != n_devices:
        raise ValueError(f"run_dryrun({n_devices}): the mesh has "
                         f"{mesh.size} shards")
    spec, _ = mm1.build()
    reps = 32 * n_devices
    pooled, events = sharded_arm(mesh, spec, device)
    mean = float(sm.mean(pooled))
    out = {"events": int(events), "mean": mean,
           "stream_mesh_events": _stream_mesh(mesh, n_devices, spec, reps,
                                              int(events), pooled, device),
           "serve_mesh_events": _serve_mesh(mesh, n_devices, spec, device),
           "kernel_mesh_events": _kernel_mesh(mesh, n_devices, device),
           "awacs_mesh_events": _awacs_mesh(mesh, n_devices, device)}
    print(f"dryrun_multichip OK: {n_devices} devices, {out['events']} events, "
          f"mean wait {mean:.3f}, stream-mesh events "
          f"{out['stream_mesh_events']}, serve-mesh events "
          f"{out['serve_mesh_events']}, "
          f"kernel-mesh events {out['kernel_mesh_events']}, "
          f"awacs-boundary-mesh events {out['awacs_mesh_events']}",
          flush=True)
    return out


def sharded_arm(mesh, spec, device="cuda"):
    """The sharded experiment over ``mesh``: mm1 (``spec``) at 32
    replications a shard x 50 objects, seed 1, which catch a cross-shard
    statistics fault (wrong merge weights, overlapping or dropped
    shards); at 8 shards in the f64 profile the pooled mean is the
    golden.  Returns ``(pooled Summary, total events)``."""
    from cimba_tpu_torch import config
    from cimba_tpu_torch.models import mm1
    from cimba_tpu_torch.runner import experiment as ex
    from cimba_tpu_torch.stats import summary as sm

    reps = 32 * mesh.size
    fn = ex.make_sharded_experiment(spec, reps, mesh, device=device)
    pooled, n_failed, events = fn(mm1.params(50), seed=1)
    assert int(n_failed) == 0, f"dryrun had failed replications: {n_failed}"
    assert int(pooled.n) == reps * 50, int(pooled.n)
    mean = float(sm.mean(pooled))
    assert mean > 0.0
    if mesh.size == 8 and config.active_profile() == "f64":
        # device placement must not leak into pooled statistics
        assert abs(mean - GOLDEN_MEAN_8) <= 1e-9 * GOLDEN_MEAN_8, (
            mean, GOLDEN_MEAN_8)
    return pooled, events


def _stream_mesh(mesh, n_devices, spec, n_reps, mono_events, mono_pooled,
                 device) -> int:
    """Waves of 8 lanes a shard over the mesh: the event count and the
    pooled statistics of the sharded experiment."""
    from cimba_tpu_torch.models import mm1
    from cimba_tpu_torch.runner import experiment as ex
    from cimba_tpu_torch.stats import summary as sm

    st = ex.run_experiment_stream(
        spec, mm1.params(50), n_reps, wave_size=8 * n_devices,
        chunk_steps=32, seed=1, mesh=mesh, device=device)
    assert int(st.n_failed) == 0, f"stream dryrun failures: {st.n_failed}"
    assert int(st.total_events) == mono_events, (int(st.total_events),
                                                 mono_events)
    assert float(st.summary.n) == float(mono_pooled.n)
    m_mono, m_st = float(sm.mean(mono_pooled)), float(sm.mean(st.summary))
    assert abs(m_st - m_mono) <= 1e-9 * abs(m_mono), (m_st, m_mono)
    assert st.n_waves == n_reps // (8 * n_devices), st.n_waves
    return int(st.total_events)


#: the serve arm's requests: (label, mm1 objects, seed), 8 replications a
#: shard each (the reference's ``_dryrun_serve_mesh`` cases)
SERVE_CASES = (("a", 40, 1), ("b", 60, 1), ("c", 40, 4))


def _serve_mesh(mesh, n_devices, spec, device) -> int:
    """Three threaded clients of a service over the mesh (parity: the
    reference's ``_dryrun_serve_mesh``): "a" and "b" pack into one
    sharded wave, "c" another seed; each result bitwise its direct mesh
    stream through the same program cache.  Returns the served events."""
    import threading

    import torch

    from cimba_tpu_torch import serve, tree
    from cimba_tpu_torch.models import mm1
    from cimba_tpu_torch.runner import experiment as ex

    cache = serve.ProgramCache()
    per_req = 8 * n_devices
    out = {}
    with serve.Service(max_wave=4 * per_req, mesh=mesh, cache=cache,
                       device=device) as svc:
        def client(label, n, seed):
            out[label] = svc.submit(serve.Request(
                spec, mm1.params(n), per_req, seed=seed, wave_size=per_req,
                chunk_steps=32, label=label)).result(600)

        ts = [threading.Thread(target=client, args=c) for c in SERVE_CASES]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    total = 0
    for label, n, seed in SERVE_CASES:
        direct = ex.run_experiment_stream(
            spec, mm1.params(n), per_req, wave_size=per_req, chunk_steps=32,
            seed=seed, mesh=mesh, program_cache=cache, device=device)
        res = out[label]
        assert int(res.n_failed) == 0, f"serve-mesh {label} failures"
        for x, y in zip(tree.leaves((res.summary, res.total_events)),
                        tree.leaves((direct.summary, direct.total_events))):
            assert torch.equal(x.cpu(), y.cpu()), f"serve-mesh {label}"
        total += int(res.total_events)
    return total


def _model_mesh(mesh, n_devices: int, build, params, label, device) -> int:
    """One model's chunks sharded, f32, 2 lanes a shard, K=32: every
    lane's event count and clock equal to the unsharded run's."""
    import torch

    from cimba_tpu_torch import config
    from cimba_tpu_torch.runner import experiment as ex

    with config.profile("f32"):
        spec, _ = build()
        R = 2 * n_devices
        single = ex.run_experiment(spec, params, R, seed=2026,
                                   chunk_steps=32, device=device)
        sharded = ex.run_experiment(spec, params, R, seed=2026,
                                    chunk_steps=32, device=device,
                                    mesh=mesh)
        assert torch.equal(single.sims.n_events, sharded.sims.n_events), \
            label
        assert torch.equal(single.sims.clock, sharded.sims.clock), label
        assert int(sharded.sims.err.sum()) == 0, f"{label} dryrun errors"
        return int(sharded.sims.n_events.sum())


def _kernel_mesh(mesh, n_devices: int, device) -> int:
    from cimba_tpu_torch.models import mm1

    return _model_mesh(mesh, n_devices,
                       build=lambda: mm1.build(record=False),
                       params=(1.0 / 0.9, 1.0, 20), label="kernel-mesh",
                       device=device)


def _awacs_mesh(mesh, n_devices: int, device) -> int:
    """AWACS (boundary blocks: the dwell between chunks) sharded."""
    from cimba_tpu_torch.models import awacs

    return _model_mesh(mesh, n_devices, build=lambda: awacs.build(8),
                       params=awacs.params(1.0), label="awacs-mesh",
                       device=device)


if __name__ == "__main__":
    import sys

    run_dryrun(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
               device=sys.argv[2] if len(sys.argv) > 2 else "cuda")
