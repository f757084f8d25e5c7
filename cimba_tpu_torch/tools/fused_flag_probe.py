"""The priority-queue get's fused twin as a run-time flag, on the card.

A priority-queue get whose fused twin was read from the command's tag at
run time (``tag == C_PQ_GET_HOLD``) once went wrong on the card only:
a plain get yielded as if fused.  The engine now takes the twin as a
template argument (``h_pq_get<Q, FUSED>``); the object queue's verb
(``h_queue_at``) and the buffer's (``h_buffer``) still read theirs at
run time.  This probe builds tutorial 3's generated instance (f32) twice:
from ``csrc/queue_chunk.cu`` as it is, and from a copy whose pq get
takes the twin as a run-time flag again (``h_pq_get_rt``); prints each
build's ptxas figures and SASS counts and the SASS instructions that
compare a register with the fused tag (27); holds each against the plain
engine on the card (R lanes stepped one event a launch for the first
``--steps`` events, then to t=7); and runs the run-time-flag build under
``compute-sanitizer`` (memcheck, initcheck) where the toolkit has it.
The SASS listings go to ``build/fused_flag_probe/`` (ignored by git).

Usage (from the root of a checkout, on a machine with a card)::

    python -m cimba_tpu_torch.tools.fused_flag_probe [--lanes 4096]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

from cimba_tpu_torch import _build, config, interop, tree
from cimba_tpu_torch.core import kernel_run, loop

OUT = os.path.join(os.getcwd(), "build", "fused_flag_probe")
FUSED_TAG = 27  # C_PQ_GET_HOLD


def runtime_flag_source() -> str:
    """queue_chunk.cu with the pq get's twin read at run time: a copy of
    h_pq_get that takes ``fused`` as an argument, dispatched for both
    tags with ``tag == C_PQ_GET_HOLD``."""
    src = (_build.CSRC / "queue_chunk.cu").read_text()
    m = re.search(r"template <int Q, bool FUSED, class S>\n"
                  r"__device__ __forceinline__ bool h_pq_get\(.*?\n}\n",
                  src, re.S)
    fn = m.group(0)
    rt = (fn.replace("template <int Q, bool FUSED, class S>",
                     "template <int Q, class S>")
          .replace("bool h_pq_get(", "bool h_pq_get_rt(")
          .replace("bool is_retry) {", "bool is_retry, bool fused) {")
          .replace("if constexpr (FUSED)", "if (fused)")
          .replace("return FUSED || empty;", "return fused || empty;"))
    assert rt.count("fused") == 3, rt
    src = src.replace(fn, fn + "\n" + rt)
    old = re.search(r"      case C_PQ_GET:\n.*?      case C_PQ_GET_HOLD:\n"
                    r".*?        break;\n", src, re.S).group(0)
    new = ("      case C_PQ_GET:\n      case C_PQ_GET_HOLD:\n"
           "        if constexpr (M::NPQ > 0)\n"
           "          return by_id<0, M::NPQ>(c.q, [&](auto q) {\n"
           "            return h_pq_get_rt<decltype(q)::value>(\n"
           "                s, w, p, c, is_retry, tag == C_PQ_GET_HOLD);\n"
           "          });\n        break;\n")
    return src.replace(old, new)


def build_variant(header: str, tmp: str) -> tuple:
    """(library path, ptxas report) of the run-time-flag copy."""
    cu = os.path.join(tmp, "queue_chunk_rt.cu")
    hdr = os.path.join(tmp, "gen.cuh")
    with open(cu, "w") as f:
        f.write(runtime_flag_source())
    with open(hdr, "w") as f:
        f.write(header)
    so = os.path.join(tmp, "rt.so")
    proc = subprocess.run(
        [_build.nvcc(), *_build.FLAGS, "-I", str(_build.CSRC),
         f'-DCIMBA_GEN_HEADER="{hdr}"', "-DCIMBA_GEN_ONLY", "-o", so, cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout)
    return so, proc.stdout


def ptxas_line(report: str) -> str:
    regs = re.findall(r"Used (\d+) registers", report)
    frame = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads", report)
    return f"registers {regs[-1:]}, frame/spill {frame[-1:]}"


def sass(lib: str, label: str) -> dict:
    """The chunk kernel's SASS: its instruction count and the compares
    of a register with the fused tag, the listing saved under OUT."""
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300).stdout
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"{label}.sass"), "w") as f:
        f.write(text)
    ins = [ln for ln in text.splitlines()
           if re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+[^;]*;", ln)
           and "NOP" not in ln]
    tag = [ln.strip() for ln in ins if re.search(
        rf"ISETP\.[A-Z.]+ .*0x{FUSED_TAG:x}\b", ln)]
    return {"instructions": len(ins), "fused_tag_compares": len(tag),
            "compares": tag[:12]}


def hold(lib, lay, table, spec, s0, steps: int) -> dict:
    """The instance in ``lib`` against the plain engine on the card:
    one event a launch for ``steps`` events, then to t=7."""
    def chunk(sims, k, t_end=None):
        sims = tree.map(lambda x: x.clone(), sims)
        kernel_run._launch(lib, "gen_chunk", table, sims, lay,
                           kernel_run._chunk_args((lay["E"], lay["W"]), k,
                                                  t_end))
        return sims

    one = loop.make_run(spec, max_steps=1)
    a = b = s0
    for i in range(steps):
        a, b = one(a), chunk(b, 1)
        bad = interop.diff_leaves(tree.leaves(a), tree.leaves(b), 0.0)
        if bad:
            names = [n for n, _, _ in table]
            return {"first_difference_event": i + 1,
                    "leaves": [names[k] for k, _ in bad[:6]]}
    end_p = loop.make_run(spec, t_end=7.0)(s0)
    end_k = s0
    cond = loop.make_cond(spec, 7.0)
    while bool(cond(end_k).any()):
        end_k = chunk(end_k, 64, 7.0)
    bad = interop.diff_leaves(tree.leaves(end_p), tree.leaves(end_k), 0.0)
    return {"stepped_events": steps, "to_t7_equal": not bad,
            "events": int(end_k.n_events.sum())}


def main(argv=None) -> int:
    from cimba_tpu_torch.examples import tut_3_balking as t3

    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--only", choices=("template", "runtime"))
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    out = {}
    with config.profile("f32"), tempfile.TemporaryDirectory() as tmp:
        spec = t3.build()
        s0 = loop.init_sim(spec, t3.SEED, torch.arange(args.lanes),
                           t3.params(), device=dev)
        lay, _, table = kernel_run.generated_kernel_for(spec, s0)
        libs = {}
        if args.only != "runtime":
            path, _, rep = _build.build_gen(lay["header"])
            rep = rep or path.with_suffix(".log").read_text()
            libs["template"] = (str(path), rep)
        if args.only != "template":
            libs["runtime"] = build_variant(lay["header"], tmp)
        for label, (so, rep) in libs.items():
            out[label] = {"ptxas": ptxas_line(rep), "sass": sass(so, label),
                          "card": hold(ctypes.CDLL(so), lay, table, spec,
                                       s0, args.steps)}
            print(f"fused_flag_probe {label}: " + json.dumps(out[label]),
                  flush=True)
        sanitizer = os.path.join(os.path.dirname(_build.nvcc()),
                                 "compute-sanitizer")
        if args.only is None:
            for tool in ("memcheck", "initcheck"):
                if not os.path.exists(sanitizer):
                    print(f"fused_flag_probe {tool}: no compute-sanitizer "
                          "beside nvcc", flush=True)
                    break
                try:
                    proc = subprocess.run(
                        [sanitizer, "--tool", tool, sys.executable, "-m",
                         "cimba_tpu_torch.tools.fused_flag_probe",
                         "--only", "runtime", "--lanes", "64", "--steps",
                         "8"], capture_output=True, text=True, timeout=600)
                    tail = (proc.stdout + proc.stderr).strip()[-1500:]
                    print(f"fused_flag_probe {tool}: exit "
                          f"{proc.returncode}\n{tail}", flush=True)
                except subprocess.TimeoutExpired:
                    print(f"fused_flag_probe {tool}: timed out", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
