"""Minimal pytree helpers with JAX's leaf order.

The port's state is a nest of NamedTuples and dicts of tensors, like the
JAX package's Sim.  JAX flattens a NamedTuple in field order, a dict in
sorted key order, and drops ``None``; these helpers do the same, so a
leaf list of one package lines up with the other's (see
:mod:`cimba_tpu_torch.interop`).  torch's own pytree keeps dict
insertion order, which is why the port does not use it.
"""

from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves(tree) -> list:
    """Leaves in JAX order."""
    out: list = []

    def walk(x):
        if x is None:
            return
        if _is_namedtuple(x) or isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        else:
            out.append(x)

    walk(tree)
    return out


def unflatten(template, new_leaves):
    """Rebuild ``template``'s structure with ``new_leaves`` (JAX order)."""
    it = iter(new_leaves)

    def build(x):
        if x is None:
            return None
        if _is_namedtuple(x):
            return type(x)(*[build(v) for v in x])
        if isinstance(x, (list, tuple)):
            return type(x)(build(v) for v in x)
        if isinstance(x, dict):
            return {k: build(x[k]) for k in sorted(x)}
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def map(fn, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    flat = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees differ in structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
