"""Design-by-contract assertions in three tiers (torch port of
:mod:`cimba_tpu.utils.dbc`).

Parity: ``cmb_assert_debug`` (off at NDEBUG), ``cmb_assert_release``
(off at NASSERT) and ``cmb_assert_always``.  The tiers are switched by
the environment (``CIMBA_NDEBUG``, ``CIMBA_NASSERT``, read at import) or
:func:`configure`; a tier that is off returns the Sim it was given, so a
block traced for the generated chunk kernel records nothing for it.  An
assertion that is on folds ``~pred`` into each lane's failure flag
(``api.fail``): the lane freezes with ``ERR_USER`` and the runner counts
it.  In a traced block that is a gated ``api.fail``, which the
generated kernel takes like any other.

For invariants at model-construction time use plain ``assert`` or
``raise``: those run eagerly anyway.
"""

from __future__ import annotations

import os

_ndebug = bool(int(os.environ.get("CIMBA_NDEBUG", "0") or "0"))
_nassert = bool(int(os.environ.get("CIMBA_NASSERT", "0") or "0"))


def configure(*, ndebug: bool | None = None, nassert: bool | None = None):
    """Switch assertion tiers (for blocks run or traced afterwards)."""
    global _ndebug, _nassert
    if ndebug is not None:
        _ndebug = ndebug
    if nassert is not None:
        _nassert = nassert


def debug_enabled() -> bool:
    """True when the heavyweight debug tier is on (CIMBA_NDEBUG unset).
    The reference also gates an eager check of its kernel build on it
    (the gated-handler validation); the port's kernel build has no such
    check."""
    return not _ndebug


def _check(sim, pred):
    from cimba_tpu_torch.core import api

    return api.fail(sim, ~pred)


def assert_debug(sim, pred):
    """Heavyweight invariant checks; off under CIMBA_NDEBUG (parity:
    cmb_assert_debug)."""
    if _ndebug:
        return sim
    return _check(sim, pred)


def assert_release(sim, pred):
    """Precondition checks; off under CIMBA_NASSERT (parity:
    cmb_assert_release)."""
    if _nassert:
        return sim
    return _check(sim, pred)


def assert_always(sim, pred):
    """Never switched off (parity: cmb_assert_always)."""
    return _check(sim, pred)
