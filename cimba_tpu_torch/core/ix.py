"""Lane-batched index ops: the port's replacement for core/dyn.py.

The JAX package reads and writes per-process tables through one-hot
masks, because Mosaic has no gather or scatter.  PyTorch has both, so a
read is a ``gather`` along axis 1 and a write a ``scatter`` of the
(pred-gated) new row.  ``arr`` is lane-first ``[L, N, ...]`` and ``i`` a
``[L]`` integer tensor of in-range indices; ``pred`` (``[L]`` bool, or
``True``) gates the write per lane, as the reference's handlers gate
theirs.  All ops are out of place.
"""

from __future__ import annotations

import torch


def _index(arr, i):
    idx = torch.as_tensor(i, device=arr.device).to(torch.int64)
    if idx.dim() == 0:
        idx = idx.expand(arr.shape[0])
    shape = (arr.shape[0], 1) + (1,) * (arr.dim() - 2)
    return idx.reshape(shape).expand((arr.shape[0], 1) + arr.shape[2:])


def get(arr, i):
    """``arr[l, i[l]]`` for every lane ``l``."""
    return arr.gather(1, _index(arr, i)).squeeze(1)


def put(arr, i, v, pred=True):
    """``arr[l, i[l]] = v[l]`` where ``pred[l]``; other lanes unchanged."""
    idx = _index(arr, i)
    old = arr.gather(1, idx).squeeze(1)
    v = torch.as_tensor(v, dtype=arr.dtype, device=arr.device)
    new = v.expand_as(old) if pred is True else torch.where(pred, v, old)
    return arr.scatter(1, idx, new.unsqueeze(1))


def add(arr, i, dv, pred=True):
    """``arr[l, i[l]] += dv`` where ``pred[l]``."""
    return put(arr, i, get(arr, i) + dv, pred)


def get2(arr, i, j):
    """``arr[l, i[l], j[l]]`` of an ``[L, N, M]`` table (parity:
    ``dyn.dget2``)."""
    m = arr.shape[2]
    return get(arr.reshape(arr.shape[0], -1), _flat2(i, j, m, arr.device))


def put2(arr, i, j, v, pred=True):
    """``arr[l, i[l], j[l]] = v[l]`` where ``pred[l]`` (parity:
    ``dyn.dset2``)."""
    m = arr.shape[2]
    flat = put(arr.reshape(arr.shape[0], -1), _flat2(i, j, m, arr.device),
               v, pred)
    return flat.reshape(arr.shape)


def add2(arr, i, j, dv, pred=True):
    """``arr[l, i[l], j[l]] += dv`` where ``pred[l]``."""
    return put2(arr, i, j, get2(arr, i, j) + dv, pred)


def _flat2(i, j, m, device):
    i = torch.as_tensor(i, device=device).to(torch.int64)
    j = torch.as_tensor(j, device=device).to(torch.int64)
    return i * m + j


def first_true(mask):
    """Lowest True index along axis 1 (``mask.shape[1]`` when none)."""
    n = mask.shape[1]
    ramp = torch.arange(n, device=mask.device, dtype=torch.int32)
    return torch.where(mask, ramp, n).amin(dim=1)


def get_tree(arrs, i):
    """:func:`get` of several ``[L, N]`` columns at the same index
    (parity: ``dyn.dget_tree``)."""
    return tuple(get(a, i) for a in arrs)


def put_tree(arrs, i, vals, pred=True):
    """:func:`put` of one value into each column at the same index
    (parity: ``dyn.dset_tree``)."""
    return tuple(put(a, i, v, pred) for a, v in zip(arrs, vals))
