"""Bisect a failing CUDA chunk kernel by stage (the port's counterpart of
the JAX package's ``tools/mosaic_bisect.py``).

On the card a chunk kernel fails in one of two ways: it faults (an
illegal address or a trap, which leaves the process's CUDA context
unusable, as a Mosaic check failure aborts its compile), or it departs
from the plain engine.  This driver runs stages that cover increasing
slices of the chunk kernel's work, each in its own subprocess with its
own time limit, and reports the smallest that fails:

  0 copy    every Sim leaf through the leaf-pointer array and back, byte
            for byte (K6's copy kernel, ``tools/bisect_kernels.sim_copy``)
  1 peek    every lane's event pick (K6's peek kernel) against
            ``eventset.peek_merged``, exactly, at the start and after a
            few events
  2 step1   the spec's chunk kernel with ``chunk_steps=1`` against
            ``loop.make_run(max_steps=1, defer_boundary=True)``
  3 chunk16 ``chunk_steps=16``
  4 chunk   one chunk at the default 512
  5 full    ``kernel_run.make_kernel_run`` to the end against the plain
            engine to the end

Stages 2-5 compare every leaf: integers and bools exactly, floats within
``RTOL`` of the leaf's scale.  Stage 10+n builds stage n's libraries with
``nvcc`` into a temporary directory and prints ptxas' report, without a
card (the counterpart of the reference's offline compile).  On
``--device cpu`` every stage runs the plain versions, which checks the
driver itself.

Usage (from the root of a checkout)::

    python -m cimba_tpu_torch.tools.cuda_bisect --model mmc
    python -m cimba_tpu_torch.tools.cuda_bisect --model jobshop --jobs 7
    python -m cimba_tpu_torch.tools.cuda_bisect --model mm1 --stages 0,1,15
    python -m cimba_tpu_torch.tools.cuda_bisect --model awacs 3  # one stage
    python -m cimba_tpu_torch.tools.cuda_bisect --model harbor  # generated
    python -m cimba_tpu_torch.tools.cuda_bisect --model park3   # generated
    python -m cimba_tpu_torch.tools.cuda_bisect --model park2   # generated
    python -m cimba_tpu_torch.tools.cuda_bisect --model spawnshop  # generated
    python -m cimba_tpu_torch.tools.cuda_bisect --model waitev  # generated

Without a stage it drives the stages (default 0-5), prints one JSON line
``{"stage", "ok", "s", "tail"}`` for each, stops after the first failed
stage >= 4, as the reference does, and exits 1 if any stage failed.
With a stage it runs that stage in this process and prints its JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from cimba_tpu_torch import config, interop, tree
from cimba_tpu_torch.core import kernel_run, loop

MODELS = ("mm1", "mm1-record", "mmc", "mg1", "tandem", "jobshop", "awacs",
          "balking", "harbor", "park3", "park2", "spawnshop", "waitev")
#: the harbor's horizon (its tide never ends)
HARBOR_T_END = 40.0
#: float leaves, kernel vs plain (chip_smoke.py's RTOL)
RTOL = {"f32": 2e-5, "f64": 1e-12}
#: small default shapes: lanes, objects (mm1, mmc, mg1, tandem; jobs of
#: the job shop), servers (mmc), targets and horizon (AWACS)
LANES, N_OBJECTS, SERVERS, N_TARGETS, AW_T_END = 512, 200, 3, 64, 10.0
CHUNK = {2: 1, 3: 16, 4: 512}
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Setup:
    """A bisect's model: spec, first state and the state the chunk
    stages start from (AWACS: after its first boundary round, since every
    lane's first event is the sensor's dwell)."""

    def __init__(self, model: str, device, lanes: int = LANES,
                 size=None, seed: int = 2026):
        from cimba_tpu_torch.examples import (cookbook_balking, spawn_shop,
                                              tut_2_park, tut_3_balking,
                                              tut_4_harbor)
        from cimba_tpu_torch.models import (awacs, jobshop, mg1, mm1, mmc,
                                            tandem)

        n = size or (N_TARGETS if model == "awacs" else N_OBJECTS)
        if model == "mm1":
            spec, params = mm1.build(record=False)[0], mm1.params(n)
        elif model == "mm1-record":
            spec, params = mm1.build()[0], mm1.params(n)
        elif model == "mmc":
            spec = mmc.build(SERVERS)[0]
            params = mmc.params(n, 2.5 * SERVERS / 3, 1.0)
        elif model == "mg1":  # the sweep's cells, cell-major, to `lanes`
            spec = mg1.build()[0]
            p, _ = mg1.sweep_params(n, reps_per_cell=-(-lanes // 20))
            params = tuple(x[:lanes] for x in p)
        elif model == "tandem":  # the grid's cells, cell-major
            spec = tandem.build()[0]
            p, _ = tandem.sweep_grid(n).rows(-(-lanes // 6))
            params = tuple(x[:lanes] for x in p)
        elif model == "jobshop":
            spec, params = jobshop.build()[0], jobshop.params(n)
        elif model == "awacs":
            spec, params = awacs.build(n)[0], awacs.params(AW_T_END)
        elif model == "balking":
            spec, params = cookbook_balking.build()[0], \
                cookbook_balking.params(n)
        elif model == "harbor":
            spec, params = tut_4_harbor.build(), tut_4_harbor.params()
        elif model == "park3":  # tutorial 3's jockeying park
            spec, params = tut_3_balking.build(), tut_3_balking.params()
        elif model == "park2":  # tutorial 2's cheese park
            spec, params = tut_2_park.build()[0], tut_2_park.params()
        elif model == "spawnshop":  # a process spawned per arrival
            spec, params = spawn_shop.build(), spawn_shop.params()
        elif model == "waitev":  # processes waiting on their events
            from cimba_tpu_torch.tools import usergen

            spec, params = usergen.wait_event_spec(usergen.torch_lib()), None
        else:
            raise ValueError(f"unknown model {model!r}; one of {MODELS}")
        self.model, self.spec = model, spec
        self.t_end = HARBOR_T_END if model == "harbor" else None
        self.on_card = torch.device(device).type == "cuda"
        self.s0 = loop.init_sim(spec, seed, torch.arange(lanes), params,
                                device=device)
        self.start = self.s0
        if spec.boundary_pcs:
            self.start = kernel_run.make_boundary_step(spec)(
                self.plain(self.s0, 512))
        self.lay, self.kernel, self.table = kernel_run.kernel_for(spec,
                                                                  self.s0)

    def plain(self, sims, k: int):
        """``k`` events a lane of the plain engine, boundary deferred."""
        return loop.make_run(self.spec, max_steps=k,
                             defer_boundary=True)(sims)

    def chunk(self, sims, k: int):
        """The spec's chunk kernel with ``chunk_steps=k`` on a copy of
        ``sims`` (on the CPU: its plain version)."""
        if not self.on_card:
            return self.plain(sims, k)
        return self.kernel(tree.map(lambda x: x.clone(), sims), self.lay, k)


def bits(x):
    """A tensor's bits as an integer tensor (floats compared bitwise)."""
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    if x.dtype == torch.float64:
        return x.view(torch.int64)
    return x


def compare(table, ref, got, rtol: float) -> list:
    """``[(leaf name, what)]`` where ``got`` departs from ``ref``:
    integers and bools exactly, floats within ``rtol`` of the leaf's
    scale (``interop.diff_leaves``)."""
    names = [name for name, _, _ in table]
    return [(names[k] if k >= 0 else "?", what) for k, what in
            interop.diff_leaves(tree.leaves(ref), tree.leaves(got), rtol)]


def run_stage(model: str, profile: str, device: str, stage: int,
              lanes: int = LANES, size=None) -> dict:
    """Run one stage in this process (``size``: objects of the queue
    models, jobs of the job shop, targets of AWACS); returns its result
    (``ok``, and what differed)."""
    base = stage % 10
    if stage >= 10:
        return offline(model, base)
    from cimba_tpu_torch.tools import bisect_kernels as bk

    with config.profile(profile):
        st = Setup(model, device, lanes, size)
        rtol = RTOL[profile]
        if base == 0:
            out = bk.sim_copy(st.start, st.table, st.lay)
            bad = [name for (name, _, _), a, b in
                   zip(st.table, tree.leaves(st.start), tree.leaves(out))
                   if not torch.equal(bits(a), bits(b))]
        elif base == 1:
            bad = []
            for when, sims in (("start", st.start),
                               ("after 5 events", st.plain(st.start, 5))):
                got = bk.peek(sims, st.table, st.lay)
                want = bk.peek_plain(sims)
                bad += [f"{f} ({when})" for f, a, b in
                        zip(want._fields, want, got)
                        if a.dtype != b.dtype
                        or not torch.equal(bits(a), bits(b))]
        elif base in CHUNK:
            k = CHUNK[base]
            bad = compare(st.table, st.plain(st.start, k),
                          st.chunk(st.start, k), rtol)
        elif base == 5:
            got = kernel_run.make_kernel_run(st.spec, t_end=st.t_end)(st.s0)
            want = loop.make_run(st.spec, t_end=st.t_end)(st.s0)
            bad = compare(st.table, want, got, rtol)
            if not bad and bool(loop.make_cond(st.spec, st.t_end)(got)
                                .any()):
                bad = [("lanes", "still live after the run")]
        else:
            raise ValueError(f"no stage {stage}")
        if st.on_card:
            torch.cuda.synchronize()
    launches = {"sim_copy": bk.sim_copy.launches, "peek": bk.peek.launches,
                "queue_chunk": kernel_run.queue_chunk.launches,
                "gen_chunk": kernel_run.gen_chunk.launches,
                "awacs_chunk": kernel_run.awacs_chunk.launches,
                "awacs_dwell": kernel_run.awacs_dwell.launches}
    return {"ok": not bad, "differs": [str(b) for b in bad][:8],
            "launches": launches}


def libraries(model: str, base: int) -> list:
    """The CUDA libraries stage ``base`` launches."""
    if base <= 1:
        return ["bisect_stages"]
    chunk = "awacs_chunk" if model == "awacs" else "queue_chunk"
    return [chunk, "nn_scores"] if model == "awacs" and base == 5 else [chunk]


def offline(model: str, base: int) -> dict:
    """Build stage ``base``'s libraries into a temporary directory and
    print ptxas' report: no card needed, only ``nvcc``."""
    from cimba_tpu_torch import _build

    keep = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in libraries(model, base):
            secs, report = _build.build(name, into=tmp)
            print(f"nvcc {name}: {secs:.2f} s", flush=True)
            for line in report.splitlines():
                if any(w in line for w in ("registers", "spill", "stack",
                                           "error", "Compiling")):
                    keep.append(f"{name}: {line.strip()}")
                    print(f"ptxas[{name}]: {line.strip()}", flush=True)
    return {"ok": True, "differs": [], "ptxas": keep}


def subprocess_runner(model: str, profile: str, device: str,
                      timeout: float, lanes: int = LANES, size=None):
    """``runner(stage) -> {"ok", "tail"}``: the stage in a subprocess of
    its own (a device fault leaves its CUDA context unusable), cut at
    ``timeout`` seconds."""

    def run(stage: int) -> dict:
        cmd = [sys.executable, "-m", "cimba_tpu_torch.tools.cuda_bisect",
               "--model", model, "--profile", profile, "--device", device,
               "--lanes", str(lanes), str(stage)]
        if size:
            cmd[-1:-1] = ["--size", str(size)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=timeout, cwd=ROOT)
        except subprocess.TimeoutExpired:
            return {"ok": False, "tail": f"timed out after {timeout} s"}
        res = None
        for line in reversed(proc.stdout.strip().splitlines()):
            if line.startswith("{"):
                res = json.loads(line)
                break
        ok = proc.returncode == 0 and res is not None and res["ok"]
        tail = ""
        if not ok:
            lines = (proc.stderr or "").strip().splitlines()
            keep = [ln for ln in lines if "Error" in ln or "error" in ln]
            tail = ((keep or lines)[-1] if (keep or lines) else
                    f"exit {proc.returncode}")
            if res is not None and res.get("differs"):
                tail = f"differs: {res['differs']}"
        return {"ok": ok, "tail": tail,
                "launches": (res or {}).get("launches", {}),
                "ptxas": (res or {}).get("ptxas", [])}

    return run


def drive(stages, runner, jobs: int = 1, out=sys.stdout) -> int:
    """Run ``runner(stage)`` for each stage (``jobs`` at a time) and
    print one JSON line a stage in stage order, stopping after the first
    failed stage >= 4; returns 1 if any printed stage failed, else 0."""
    stages = list(stages)
    rc = 0
    t0 = time.perf_counter()

    def timed(stage):
        t = time.perf_counter()
        res = runner(stage)
        return res, time.perf_counter() - t

    with ThreadPoolExecutor(max(1, jobs)) as pool:
        futs = [pool.submit(timed, n) for n in stages]
        for n, fut in zip(stages, futs):
            res, secs = fut.result()
            print(json.dumps({"stage": n, "ok": bool(res["ok"]),
                              "s": round(secs, 1),
                              "tail": str(res.get("tail", ""))[:300],
                              "launches": res.get("launches", {}),
                              "ptxas": res.get("ptxas", [])}),
                  file=out, flush=True)
            if not res["ok"]:
                rc = 1
                if n % 10 >= 4:
                    for f in futs:
                        f.cancel()
                    break
    print(json.dumps({"stages": len(stages), "failed": rc,
                      "s": round(time.perf_counter() - t0, 1)}),
          file=out, flush=True)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=MODELS, required=True)
    ap.add_argument("--profile", choices=("f32", "f64"), default="f32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stages", default="0,1,2,3,4,5",
                    help="comma-separated stages to drive")
    ap.add_argument("--jobs", type=int, default=1,
                    help="stages run at once (each its own process)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a stage may take")
    ap.add_argument("--lanes", type=int, default=LANES)
    ap.add_argument("--size", type=int, default=None,
                    help=f"objects of the queue models and jobs of the "
                         f"job shop (default {N_OBJECTS}), targets of "
                         f"AWACS (default {N_TARGETS})")
    ap.add_argument("stage", nargs="?", type=int,
                    help="run this one stage in this process")
    a = ap.parse_args(argv)
    if a.stage is None or a.stage < 10:  # the offline build needs no card
        config.resolve_device(a.device)
    if a.stage is not None:
        t = time.perf_counter()
        res = run_stage(a.model, a.profile, a.device, a.stage, a.lanes,
                        a.size)
        print(json.dumps({"stage": a.stage, **res,
                          "s": round(time.perf_counter() - t, 1)}),
              flush=True)
        return 0 if res["ok"] else 1
    stages = [int(x) for x in a.stages.split(",") if x.strip()]
    return drive(stages, subprocess_runner(a.model, a.profile, a.device,
                                           a.timeout, a.lanes, a.size),
                 a.jobs)


if __name__ == "__main__":
    sys.exit(main())
