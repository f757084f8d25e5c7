"""Hardware-entropy seeding (torch port of :mod:`cimba_tpu.utils.seed`).

Parity: ``cmb_random_hwseed`` — RDSEED with an RDRAND fallback and a
clock mashup last.  Python reaches the kernel's entropy pool through
``os.urandom`` (fed by RDSEED/RDRAND where the CPU has them); the
clock fallback mirrors the reference's.
"""

from __future__ import annotations

import os
import time


def hwseed() -> int:
    """A 64-bit hardware-entropy seed (parity: cmb_random_hwseed)."""
    try:
        return int.from_bytes(os.urandom(8), "little")
    except NotImplementedError:  # no OS entropy: clock mashup fallback
        t = time.time_ns()
        m = time.monotonic_ns()
        return (t * 0x9E3779B97F4A7C15 ^ (m << 17) ^ os.getpid()) & (
            (1 << 64) - 1
        )
