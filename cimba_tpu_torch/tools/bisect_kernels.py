"""K6, the two kernels of the chunk-kernel bisect (``csrc/bisect_stages.cu``).

Counterparts of stages 0 and 1 of the JAX package's Mosaic bisect
(``tools/mosaic_bisect.py``: "copy" at ``:68``, "pop" at ``:94``).  Both
take a Sim through the leaf-pointer array the chunk kernels take
(:mod:`cimba_tpu_torch.core.kernel_run`), checked against the spec's
leaf table:

* :func:`sim_copy` — every leaf, in -> out, byte for byte: the plumbing
  that every chunk kernel shares.  Plain version: a leaf-wise clone.
* :func:`peek` — per lane, the engine's event pick
  (``eventset.peek_merged``).  Plain version: ``peek_merged`` itself.

On a Sim on the card each wrapper launches its kernel (and adds one to
its ``launches``); on a CPU Sim it runs the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from cimba_tpu_torch import tree
from cimba_tpu_torch.config import INDEX
from cimba_tpu_torch.core import eventset as ev
from cimba_tpu_torch.core import kernel_run, loop


def _checked(sims: loop.Sim, table, lay: dict):
    leaves = tree.leaves(sims)
    kernel_run._check_leaves(leaves, table, lay, sims.clock.dtype,
                             sims.n_events.dtype)
    return leaves


def sim_copy_plain(sims: loop.Sim) -> loop.Sim:
    return tree.map(lambda x: x.clone(), sims)


def sim_copy(sims: loop.Sim, table, lay: dict) -> loop.Sim:
    """A copy of ``sims`` (``table``/``lay``: the spec's leaf table and
    layout, ``kernel_run.kernel_for``), made by the copy kernel on the
    card; on the current stream, without synchronising."""
    if not sims.clock.is_cuda:
        return sim_copy_plain(sims)
    from cimba_tpu_torch import _build

    leaves = _checked(sims, table, lay)
    lanes = leaves[0].shape[0]
    outs = [torch.empty_like(x) for x in leaves]
    n = len(leaves)
    fn = _build.load("bisect_stages").cimba_sim_copy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    ins = (ctypes.c_void_p * n)(*[x.data_ptr() for x in leaves])
    out_p = (ctypes.c_void_p * n)(*[y.data_ptr() for y in outs])
    rows = (ctypes.c_int * n)(*[x.numel() // lanes for x in leaves])
    sizes = (ctypes.c_int * n)(*[x.element_size() for x in leaves])
    with torch.cuda.device(leaves[0].device):
        rc = fn(ins, out_p, rows, sizes, n, lanes,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sim_copy kernel launch failed (code {rc})")
    sim_copy.launches += 1
    return tree.unflatten(sims, outs)


def peek_plain(sims: loop.Sim) -> ev.Event:
    return ev.peek_merged(sims.events, sims.wakes, sims.procs.prio,
                          loop.K_PROC)[0]


def peek(sims: loop.Sim, table, lay: dict) -> ev.Event:
    """Every lane's next event, not consumed (``eventset.Event`` of
    ``[L]`` tensors), computed by the peek kernel on the card; on the
    current stream, without synchronising."""
    if not sims.clock.is_cuda:
        return peek_plain(sims)
    from cimba_tpu_torch import _build

    leaves = _checked(sims, table, lay)
    lanes, dev = leaves[0].shape[0], leaves[0].device
    out = ev.Event(
        time=torch.empty((lanes,), dtype=sims.clock.dtype, device=dev),
        prio=torch.empty((lanes,), dtype=INDEX, device=dev),
        kind=torch.empty((lanes,), dtype=INDEX, device=dev),
        subj=torch.empty((lanes,), dtype=INDEX, device=dev),
        arg=torch.empty((lanes,), dtype=INDEX, device=dev),
        found=torch.empty((lanes,), dtype=torch.bool, device=dev),
        handle=torch.empty((lanes,), dtype=INDEX, device=dev),
    )
    lib = _build.load("bisect_stages")
    fn = getattr(lib, "cimba_peek_f32" if sims.clock.dtype == torch.float32
                 else "cimba_peek_f64")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    ptrs = (ctypes.c_void_p * len(leaves))(*[x.data_ptr() for x in leaves])
    outs = (ctypes.c_void_p * 7)(*[x.data_ptr() for x in out])
    with torch.cuda.device(dev):
        rc = fn(ptrs, len(leaves), lanes, lay["E"], lay["P"], loop.K_PROC,
                outs, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"peek kernel launch failed (code {rc})")
    peek.launches += 1
    return out


sim_copy.launches = 0
peek.launches = 0
