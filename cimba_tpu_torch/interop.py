"""Carry simulation state between the JAX package and the port.

A discrete-event simulation has no weights; its state plays that part.
The JAX package's batched Sim, as a list of numpy leaves in
``jax.tree.leaves`` order, converts to the port's lane-first Sim and
back, so a test can stop a run in one package and finish it in the
other.  Threefry words travel as ``uint32`` on the JAX side and as
int64 values in ``[0, 2**32)`` here; every other leaf keeps its dtype.
A Sim's per-lane horizon (``Sim.t_stop``, the last leaf where a Sim has
one) travels both ways like any other leaf.
A recording queue's length accumulator (``queues.acc``), a binary
resource's holder and utilization accumulator (``resources.holder``,
``resources.acc``) travel like any other leaf: the spec's template gives
each its place and shape.
"""

from __future__ import annotations

import numpy as np
import torch

from cimba_tpu_torch import config, tree
from cimba_tpu_torch.core.loop import Sim, init_sim
from cimba_tpu_torch.core.model import ModelSpec


def sim_from_numpy(leaves, spec: ModelSpec, params=None, *,
                   device="cuda") -> Sim:
    """The port's Sim from the reference's batched Sim leaves (numpy
    arrays in ``jax.tree.leaves`` order, e.g.
    ``[np.asarray(x) for x in jax.tree.leaves(sims)]``), the ``t_stop``
    leaf, the last, included where that Sim carries one.  ``params`` is
    any parameter set the spec's user state accepts, shared or a sweep's
    (leading axis the lane count): it only shapes the template the leaves
    are checked against."""
    dev = config.resolve_device(device)
    prof = "f32" if np.asarray(leaves[0]).dtype == np.float32 else "f64"
    lanes = np.asarray(leaves[0]).shape[0]
    with config.profile(prof):
        tmpl = init_sim(spec, 0, torch.arange(1), _one_lane(params, lanes),
                        device="cpu")
        if len(leaves) == len(tree.leaves(tmpl)) + 1:
            # the reference's Sim carries a per-lane horizon: its last leaf
            tmpl = tmpl._replace(t_stop=torch.zeros(1, dtype=config.time()))
    want = tree.leaves(tmpl)
    if len(leaves) != len(want):
        raise ValueError(f"{len(leaves)} leaves given, spec {spec.name!r} "
                         f"has {len(want)}")
    out = []
    for x, w in zip(leaves, want):
        a = np.asarray(x)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        t = torch.from_numpy(np.array(a, copy=True))
        if t.dtype != w.dtype or tuple(t.shape[1:]) != tuple(w.shape[1:]):
            raise ValueError(f"leaf {t.dtype} {tuple(t.shape)} does not fit "
                             f"{w.dtype} [L, {tuple(w.shape[1:])}]")
        out.append(t.to(dev))
    return tree.unflatten(tmpl, out)


def _one_lane(params, lanes: int):
    """The first lane's row of a sweep's parameters (leaves with leading
    axis ``lanes``); scalars and other leaves as given."""
    if isinstance(params, (tuple, list)):
        return type(params)(_one_lane(x, lanes) for x in params)
    if isinstance(params, dict):
        return {k: _one_lane(v, lanes) for k, v in params.items()}
    if np.ndim(params) > 0 and np.shape(params)[0] == lanes:
        return params[:1]
    return params


def nn_weights_from_numpy(w1, b1, w2, b2, w3, b3, *,
                          device="cuda") -> tuple:
    """The AWACS detection MLP's parameters as f32 tensors, in the order
    of the port's own (``models.awacs._weights``), from numpy arrays such
    as ``[np.asarray(w) for w in cimba_tpu.models.awacs._NN_WEIGHTS]``, so
    that the two packages' scorers can be checked to share them; shapes
    as the reference's: w1 [8, 32], b1 [32], w2 [32, 32], b2 [32], w3
    [33, 1], b3 [1].  The tensors go to ``device``, the card unless the
    caller asks for the CPU."""
    dev = config.resolve_device(device)
    shapes = ((8, 32), (32,), (32, 32), (32,), (33, 1), (1,))
    out = []
    for a, shape in zip((w1, b1, w2, b2, w3, b3), shapes):
        a = np.asarray(a)
        if a.dtype != np.float32 or a.shape != shape:
            raise ValueError(f"weight {a.dtype} {a.shape}, want float32 "
                             f"{shape}")
        out.append(torch.from_numpy(np.array(a, copy=True)).to(dev))
    return tuple(out)


def diff_leaves(ref, port, rtol: float) -> list:
    """Leaf-by-leaf parity of two leaf lists (numpy or tensors, e.g. the
    reference's and ``sim_to_numpy``'s): integer and bool leaves must be
    equal, float leaves must share their non-finite entries and agree
    within ``rtol`` times the leaf's largest finite magnitude.  Returns
    ``[(index, what), ...]`` — empty when they agree."""
    bad = []
    if len(ref) != len(port):
        return [(-1, f"{len(ref)} vs {len(port)} leaves")]
    for k, (a, b) in enumerate(zip(ref, port)):
        a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
        b = np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b)
        if a.shape != b.shape:
            bad.append((k, f"shape {a.shape} vs {b.shape}"))
        elif np.issubdtype(a.dtype, np.floating):
            fa, fb = np.isfinite(a), np.isfinite(b)
            if not (np.array_equal(fa, fb)
                    and np.array_equal(a[~fa], b[~fb])):
                bad.append((k, "non-finite entries differ"))
                continue
            scale = float(np.abs(a[fa]).max()) if fa.any() else 0.0
            d = float(np.abs(a[fa] - b[fb]).max()) if fa.any() else 0.0
            if d > rtol * max(scale, np.finfo(a.dtype).tiny):
                bad.append((k, f"max |diff| {d} > {rtol} x {scale}"))
        elif not np.array_equal(a.astype(np.int64), b.astype(np.int64)):
            bad.append((k, f"{int((a != b).sum())} entries differ"))
    return bad


def sim_to_numpy(sim: Sim) -> list:
    """The reference's leaf list of the port's Sim (``uint32`` words),
    ready for ``jax.tree.unflatten``."""
    out = []
    rng_ids = {id(x) for x in tree.leaves(sim.rng)}
    for x in tree.leaves(sim):
        a = x.detach().cpu().numpy()
        if id(x) in rng_ids:
            a = a.astype(np.uint32)
        out.append(a)
    return out
