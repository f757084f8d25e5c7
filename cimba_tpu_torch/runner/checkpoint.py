"""Checkpoint and resume of a batched Sim (torch port of
:mod:`cimba_tpu.runner.checkpoint`).

A replication's whole state, its Threefry counter included, is the Sim,
so a run saved at a chunk boundary and restored goes on exactly as the
uninterrupted run (``runner.experiment.run_experiment_chunked``).

The file is the reference's: a numpy ``.npz`` holding ``leaf_i`` for the
i-th leaf in JAX's leaf order, as the JAX package's Sim has it (Threefry
words as ``uint32``, every other leaf in its own dtype), and a
``__spec__`` entry, the JSON fingerprint (``_FORMAT``, the caller's tag,
each leaf's shape and dtype), as ``uint8`` bytes.  A checkpoint of one
package can therefore be read by the other, and a chunked run of one
resumed from the other's file (the tags are the same).  A save writes a temp file
of a unique name beside the target, syncs it to disk and renames it over
the target, so a crash leaves the previous checkpoint or none, never a
torn one; ``restore`` reads only the target, so a leftover temp file is
ignored.  ``restore`` checks the format, the tag and every leaf's shape
and dtype against ``like`` and names the first that differs.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from cimba_tpu_torch import config, tree
from cimba_tpu_torch.random.bits import RandomState

#: the layout's version, the reference's
_FORMAT = 1


def _words(x) -> set:
    """The ids of the Threefry word leaves in ``x``, which the file holds
    as ``uint32``."""
    out = set()

    def walk(v):
        if isinstance(v, RandomState):
            out.update(id(w) for w in tree.leaves(v))
        elif isinstance(v, tuple):
            for w in v:
                walk(w)
        elif isinstance(v, dict):
            for w in v.values():
                walk(w)

    walk(x)
    return out


def _as_numpy(x, word: bool) -> np.ndarray:
    a = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
         else np.asarray(x))
    return a.astype(np.uint32) if word else a


def _fingerprint(arrays, tag: Optional[str]) -> str:
    return json.dumps({
        "format": _FORMAT,
        "tag": tag,
        "leaves": [[list(a.shape), str(a.dtype)] for a in arrays],
    })


def save(path: str, sims: Any, *, tag: Optional[str] = None) -> None:
    """Write a batched Sim (or any tree of tensors) to ``path``
    (``.npz``), atomically: a temp file of a unique name in the same
    directory, synced to disk, then renamed over ``path``.  ``tag`` is
    stored in the fingerprint and checked as it is at restore."""
    words = _words(sims)
    arrays = [_as_numpy(x, id(x) in words) for x in tree.leaves(sims)]
    named = {f"leaf_{i}": a for i, a in enumerate(arrays)}
    named["__spec__"] = np.frombuffer(
        _fingerprint(arrays, tag).encode(), dtype=np.uint8)
    path = os.path.abspath(path)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **named)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def spec_tag(spec: Any) -> str:
    """A spec's fingerprint tag: its name, process count, capacities and
    the active dtype profile, as the reference writes it (parity:
    ``cimba_tpu.runner.checkpoint.spec_tag``)."""
    def dtype(role, dt):
        return f"config.{role}_DTYPE(={str(dt).replace('torch.', '')})"

    return json.dumps({
        "model": getattr(spec, "name", "?"),
        "n_procs": getattr(spec, "n_procs", -1),
        "event_cap": getattr(spec, "event_cap", -1),
        "queue_cap_max": getattr(spec, "queue_cap_max", -1),
        "pqueue_cap_max": getattr(spec, "pqueue_cap_max", -1),
        "real": dtype("REAL", config.real()),
        "time": dtype("TIME", config.time()),
    })


def run_tag(spec: Any, *, seed: int, params: Any = None,
            t_end: Any = None) -> str:
    """:func:`spec_tag` with the run's seed, horizon and a digest of its
    parameters, broadcast to the run's lanes by the caller as the
    reference's runner broadcasts them: a resume under another seed,
    ``t_end`` or parameters has the same shapes and would go on with the
    old run, so the tag tells them apart (``chunk_steps`` changes no
    trajectory and stays out)."""
    base = json.loads(spec_tag(spec))
    base["seed"] = int(seed)
    base["t_end"] = None if t_end is None else float(t_end)
    if params is not None:
        h = hashlib.sha256()
        for x in tree.leaves(params):
            a = _as_numpy(x, False)
            h.update(f"{a.shape}:{a.dtype}:".encode())
            h.update(a.tobytes())
        base["params_sha256"] = h.hexdigest()
    return json.dumps(base)


def save_resumable(path: str, sims: Any, *, spec: Any = None,
                   progress: int = 0, tag: Optional[str] = None) -> None:
    """Save a chunked run at a chunk boundary: the Sim and its chunk
    count ``progress`` (an int32 after the Sim's leaves), tagged with
    ``tag``, or with :func:`spec_tag` of ``spec`` where no tag is
    given."""
    if tag is None and spec is not None:
        tag = spec_tag(spec)
    save(path, (sims, np.asarray(int(progress), np.int32)), tag=tag)


def restore_resumable(path: str, like: Any, *, spec: Any = None,
                      tag: Optional[str] = None, device=None):
    """Inverse of :func:`save_resumable`: ``(sims, progress)``, ``like`` a
    Sim of the run's shapes (see :func:`restore`)."""
    if tag is None and spec is not None:
        tag = spec_tag(spec)
    sims, progress = restore(
        path, (like, torch.zeros((), dtype=torch.int32)), tag=tag,
        device=device)
    return sims, int(progress)


def restore(path: str, like: Any, *, tag: Optional[str] = None,
            device=None) -> Any:
    """Read a checkpoint written by :func:`save` (or by the reference's)
    into the structure of ``like``, whose leaves give each leaf's shape
    and dtype (a Sim on the CPU or on the card).  The leaves go to
    ``device``, by default ``like``'s.  Raises ValueError naming the
    first mismatch of the format, the tag, the leaf count or a leaf's
    shape or dtype."""
    words = _words(like)
    want = tree.leaves(like)
    dev = (torch.device(device) if device is not None
           else want[0].device if want else torch.device("cpu"))
    with np.load(path) as data:
        if "__spec__" not in data.files:
            if tag is not None:
                raise ValueError(
                    "checkpoint has no spec fingerprint but tag "
                    "verification was requested: cannot prove it matches "
                    "this spec")
        else:
            saved = json.loads(bytes(data["__spec__"]).decode())
            if saved.get("format") != _FORMAT:
                raise ValueError(f"checkpoint format {saved.get('format')}"
                                 f" != supported {_FORMAT}")
            if tag is not None and saved.get("tag") != tag:
                raise ValueError(
                    "checkpoint spec fingerprint mismatch:\n"
                    f"  saved:     {saved.get('tag')}\n"
                    f"  restoring: {tag}\n"
                    "the model, capacities, profile, seed, horizon or "
                    "parameters changed between save and restore")
        names = [f for f in data.files if f != "__spec__"]
        if len(names) != len(want):
            raise ValueError(f"checkpoint has {len(names)} leaves, expected "
                             f"{len(want)}: model structure changed?")
        out = []
        for i, x in enumerate(want):
            arr = data[f"leaf_{i}"]
            word = id(x) in words
            shape = tuple(x.shape)
            dt = (np.dtype(np.uint32) if word
                  else torch.empty((), dtype=x.dtype).numpy().dtype)
            if tuple(arr.shape) != shape:
                raise ValueError(
                    f"checkpoint leaf {i}: shape {tuple(arr.shape)} != "
                    f"expected {shape}: capacity or batch size changed "
                    "between save and restore?")
            if arr.dtype != dt:
                raise ValueError(
                    f"checkpoint leaf {i}: dtype {arr.dtype} != expected "
                    f"{dt}: dtype profile changed between save and "
                    "restore?")
            t = torch.from_numpy(np.array(
                arr.astype(np.int64) if word else arr, copy=True))
            out.append(t.to(dev))
    return tree.unflatten(like, out)
