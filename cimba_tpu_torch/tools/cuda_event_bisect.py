"""Find the first event at which a CUDA chunk kernel departs from the
plain engine (the port's counterpart of the JAX package's
``tools/mosaic_eqn_bisect.py``).

The reference bisects a prefix of the traced chunk program's equations,
because its chunk kernel failed to compile.  The port's chunk kernels
are written by hand, so it has no traced program; its failure is a run
that departs from the plain engine, or faults.  So the prefix here is one
of events: the smallest ``k <= K`` such that the spec's chunk kernel
with ``chunk_steps=k`` differs from (or faults against) the plain
engine's ``k`` steps, ``loop.make_run(max_steps=k,
defer_boundary=True)``, on the same lanes.  A binary search finds it in
``1 + log2(K)`` probes.  Then it descends, as the reference recurses
into nested jaxprs:

* to the lowest lane that differs at ``k``;
* to the leaves that differ there;
* to the event the plain engine dispatched at step ``k`` on that lane
  (``eventset.peek_merged`` on the state after ``k - 1`` steps): its pid,
  the process's name, its pc and block, the signal and the time.

It prints a ``CULPRIT ...`` line, or ``no divergence within K events``.
The kernel it launches is the spec's K1 instance on a prefix; it has no
kernel of its own.

:func:`find_divergence` takes the kernel as a callable, so a caller can
drive it in process with a planted divergence.  From the command line
each probe runs in a subprocess, because a device fault leaves the
process's CUDA context unusable::

    python -m cimba_tpu_torch.tools.cuda_event_bisect --model mmc --K 64
    python -m cimba_tpu_torch.tools.cuda_event_bisect --model mm1 --device cpu
    python -m cimba_tpu_torch.tools.cuda_event_bisect --model jobshop --K 16
    python -m cimba_tpu_torch.tools.cuda_event_bisect --model harbor \
        --profile f64 --K 64
    python -m cimba_tpu_torch.tools.cuda_event_bisect --model park3 --K 16
    python -m cimba_tpu_torch.tools.cuda_event_bisect --model park2 --K 16
    python -m cimba_tpu_torch.tools.cuda_event_bisect --model spawnshop \
        --profile f64 --K 64
    python -m cimba_tpu_torch.tools.cuda_event_bisect --model waitev --K 64

(``balking``, ``harbor``, ``park3``, ``park2`` and ``spawnshop``, the user
programs of ``cimba_tpu_torch.examples``, and ``waitev``, the reference's
kernel-path model of ``wait_event`` (``tools/usergen.wait_event_spec``),
run on their generated K1 instances.)

It exits 1 when it finds a divergence, 0 when it finds none.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from cimba_tpu_torch import config, tree
from cimba_tpu_torch.core import loop
from cimba_tpu_torch.tools import bisect_kernels as bk
from cimba_tpu_torch.tools import cuda_bisect as cb


class Probe(Exception):
    """A probe that faulted (raised, or its subprocess failed)."""


def lane_diffs(table, ref, got, rtol: float):
    """``{lane: [leaf names]}`` of the lanes where ``got`` departs from
    ``ref``: integers and bools exactly, floats where finiteness differs
    or ``|diff|`` exceeds ``rtol`` times the leaf's finite scale."""
    out: dict = {}
    for (name, _, _), a, b in zip(table, tree.leaves(ref), tree.leaves(got)):
        a2, b2 = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
        if a.is_floating_point():
            fa, fb = torch.isfinite(a2), torch.isfinite(b2)
            scale = float(a2[fa].abs().max()) if bool(fa.any()) else 0.0
            tol = rtol * max(scale, torch.finfo(a.dtype).tiny)
            d = torch.where(fa & fb, (a2 - b2).abs(),
                            torch.zeros_like(a2))
            bad = (fa != fb) | (~fa & ~fb & (a2 != b2) & ~(
                torch.isnan(a2) & torch.isnan(b2))) | (d > tol)
        else:
            bad = a2 != b2
        for lane in bad.any(dim=1).nonzero().flatten().tolist():
            out.setdefault(lane, []).append(name)
    return out


def dispatched(spec, before, lane: int) -> dict:
    """The event the plain engine dispatches next on ``lane`` of
    ``before``, with its process and block."""
    e = bk.peek_plain(before)
    found = bool(e.found[lane])
    pid = int(e.subj[lane])
    out = {"found": found, "time": float(e.time[lane]), "pid": pid,
           "signal": int(e.arg[lane]), "kind": int(e.kind[lane])}
    if found and 0 <= pid < spec.n_procs:
        pc = int(before.procs.pc[lane, pid])
        out.update(process=spec.proc_names[pid], pc=pc,
                   block=getattr(spec.blocks[pc], "__name__", str(pc)))
    return out


def find_divergence(spec, sims, kernel, K: int = 64, rtol: float = 0.0,
                    table=None) -> dict:
    """The smallest ``k <= K`` at which ``kernel(sims, k)`` (the state
    after the chunk kernel with ``chunk_steps=k``; raising
    :class:`Probe` for a fault) departs from the plain engine's ``k``
    steps, with the lane, leaves and event it comes to.  Returns
    ``{"k": None, ...}`` when nothing differs within ``K`` events."""
    from cimba_tpu_torch.core import kernel_run

    table = table or kernel_run.kernel_for(spec)[2]
    step = loop.make_run(spec, max_steps=1, defer_boundary=True)
    plain = [sims]
    for _ in range(K):
        plain.append(step(plain[-1]))
    probes = 0

    def bad(k):
        nonlocal probes
        probes += 1
        try:
            got = kernel(sims, k)
        except Probe as e:
            return {"fault": str(e)}
        diffs = lane_diffs(table, plain[k], got, rtol)
        return {"lanes": diffs} if diffs else None

    res = bad(K)
    if res is None:
        return {"k": None, "K": K, "probes": probes}
    lo, hi, at_hi = 0, K, res
    while hi - lo > 1:
        mid = (lo + hi) // 2
        r = bad(mid)
        if r is None:
            lo = mid
        else:
            hi, at_hi = mid, r
    out = {"k": hi, "K": K, "probes": probes}
    if "fault" in at_hi:
        out["fault"] = at_hi["fault"]
        return out
    lane = min(at_hi["lanes"])
    out.update(lane=lane, leaves=at_hi["lanes"][lane],
               lanes_differing=len(at_hi["lanes"]),
               event=dispatched(spec, plain[hi - 1], lane))
    return out


def describe(res: dict) -> str:
    if res["k"] is None:
        return f"no divergence within {res['K']} events ({res['probes']} probes)"
    if "fault" in res:
        return (f"CULPRIT k={res['k']}: the kernel faults from event "
                f"{res['k']} on ({res['fault']}; {res['probes']} probes)")
    e = res["event"]
    what = (f"pid {e['pid']} ({e.get('process')}) pc {e.get('pc')} "
            f"({e.get('block')}) signal {e['signal']} at t={e['time']!r}"
            if e["found"] else "no event (the lane had stopped)")
    return (f"CULPRIT k={res['k']} lane={res['lane']} "
            f"leaves={res['leaves']} event: {what} "
            f"({res['lanes_differing']} lanes differ; {res['probes']} probes)")


#: seconds a probe's process may take
PROBE_TIMEOUT = 300.0


def isolated_kernel(model: str, profile: str, device: str, lanes: int,
                    size):
    """``kernel(sims, k)`` that runs each probe in a subprocess of its
    own on the model's first chunk state (``cuda_bisect.Setup``), and
    reads the state it leaves back from a file."""
    root = cb.ROOT

    def kernel(sims, k):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "probe.pt")
            cmd = [sys.executable, "-m",
                   "cimba_tpu_torch.tools.cuda_event_bisect", "--model",
                   model, "--profile", profile, "--device", device,
                   "--lanes", str(lanes), "--probe", str(k), "--out", path]
            if size:
                cmd += ["--size", str(size)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=PROBE_TIMEOUT, cwd=root)
            except subprocess.TimeoutExpired:
                raise Probe(f"probe k={k} timed out after {PROBE_TIMEOUT} s")
            if proc.returncode != 0:
                lines = proc.stderr.strip().splitlines()
                raise Probe(lines[-1] if lines else
                            f"probe k={k} exited {proc.returncode}")
            leaves = torch.load(path, map_location=sims.clock.device)
        return tree.unflatten(sims, leaves)

    return kernel


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=cb.MODELS, required=True)
    ap.add_argument("--profile", choices=("f32", "f64"), default="f32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--K", type=int, default=64)
    ap.add_argument("--lanes", type=int, default=cb.LANES)
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--probe", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    config.resolve_device(a.device)
    with config.profile(a.profile):
        st = cb.Setup(a.model, a.device, a.lanes, a.size)
        if a.probe is not None:  # one probe: the kernel's state to a file
            got = st.chunk(st.start, a.probe)
            torch.save([x.cpu() for x in tree.leaves(got)], a.out)
            return 0
        kernel = isolated_kernel(a.model, a.profile, a.device, a.lanes,
                                 a.size)
        t = time.perf_counter()
        res = find_divergence(st.spec, st.start, kernel, a.K,
                              cb.RTOL[a.profile], st.table)
        res["s"] = round(time.perf_counter() - t, 1)
    print(json.dumps(res), flush=True)
    print(describe(res), flush=True)
    return 0 if res["k"] is None else 1


if __name__ == "__main__":
    sys.exit(main())
