"""Bulk sampler speed on the card: the kernels K2-K4 and their plain versions.

Counterpart of the block variants of ``tools/sampler_bench.py`` (the
reference's sampler battery, `test/test_random.c:193-245`): R streams x
N draws each, by ``block_kernels.exponential_block``, ``normal_block``
and ``exponential_block_zig``, in both dtype profiles.  Run on a machine
with an NVIDIA card:

    python -m cimba_tpu_torch.random.sampler_bench [R] [N]

(R = 256 and N = 65536 by default).  Prints one JSON line per variant,
profile and version (``kernel`` or ``plain``): samples/s from the
device time of one call, the device, R and N.  Without a card it exits
with an error: it measures nothing on the CPU.
"""

from __future__ import annotations

import json
import sys

import torch

from cimba_tpu_torch import config
from cimba_tpu_torch.random import bits, block_kernels

VARIANTS = (
    ("exp_inversion", block_kernels.exponential_block,
     block_kernels.exponential_block_plain),
    ("exp_ziggurat", block_kernels.exponential_block_zig,
     block_kernels.exponential_block_zig_plain),
    ("nor_inversion", block_kernels.normal_block,
     block_kernels.normal_block_plain),
)


def device_ms(fn, reps: int = 5, calls: int = 1) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` timings, after
    one warm-up call: CUDA events around ``calls`` calls back to back
    (the time divided by ``calls``), queued behind a ~1 ms spin of the
    card so that the host's time to issue them is not counted."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(calls):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    return sorted(times)[reps // 2]


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    rows = int(argv[0]) if len(argv) > 0 else 256
    n = int(argv[1]) if len(argv) > 1 else 65_536
    dev = config.resolve_device("cuda")
    states = bits.initialize(2026, torch.arange(rows), device=dev)
    name = torch.cuda.get_device_name(dev)
    for prof in ("f64", "f32"):
        with config.profile(prof):
            for variant, kernel, plain in VARIANTS:
                for version, fn, reps in (("kernel", kernel, 5),
                                          ("plain", plain, 1)):
                    ms = device_ms(lambda: fn(states, n), reps)
                    print(json.dumps({
                        "sampler": f"{variant}_{version}", "profile": prof,
                        "samples_per_sec": rows * n / (ms * 1e-3),
                        "ms": ms, "device": name, "R": rows, "N": n,
                    }), flush=True)


if __name__ == "__main__":
    main()
