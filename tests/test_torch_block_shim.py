"""The bulk samplers K2-K4 built with g++ on the CPU, against their plain
versions.

``cimba_tpu_torch.tools.gxx_shim.build_samplers`` builds
``csrc/bulk_samplers.cu`` for the host (a stand-in for ``cuda_runtime.h``,
each launch run as a loop over the grid of 3 SMs x 1 block; K4's blocks as
fibers that take turns at its ``__syncthreads()``).  K2 (the exponential
block), K3 (the normal block) and K4 (the ziggurat block) are held against
``block_kernels.*_plain`` in both profiles, at n in {1, 3, 64, 512, 777,
4097} samples a stream and R in {1, 5, 1000} streams (R = 1000 not with
n = 512 or 4097: the plain versions' Threefry over that many counters
takes seconds on one thread), with every third stream's counter crossing
2**32 inside its row (n = 1: at the advance).  The shapes reach rows of
one short run (n < 8), a row's short last run (n % 8 or n % 4 samples),
the scalar and the 16-byte vector stores (n a multiple of 4), and the
grid-stride loop stepping across rows.

The advanced counters must be equal.  The samples must agree within 4
eps of max(|x|, 1), ``chip_smoke.BLOCK_TOL``: glibc's ``log1p`` and
``exp`` are not torch's to the last place (up to ~2.3 eps measured, K3
in f64), where on the card kernel and plain version agree bit for bit.

The shim runs each thread as a warp of its own.  K3's warp vote
(``__all_sync(__activemask(), w in the central branch)``) is then the
lane's own predicate, which is exact in value since both paths compute
the same value.  The f64 kernels' exchange of log1p arguments between the
lanes of a whole warp (``log1p_run``) never runs here (no warp is whole):
each lane computes its own, and the exchange is held against the plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 5).  Every test skips where there is no ``g++``; torch runs on one
thread.
"""

import pytest
import torch

from cimba_tpu_torch import config
from cimba_tpu_torch.random import bits, block_kernels
from cimba_tpu_torch.tools import gxx_shim

torch.set_num_threads(1)

BLOCK_TOL = 4
#: n -> the stream counts it runs at
ROWS = {1: (1, 5, 1000), 3: (1, 5, 1000), 64: (1, 5, 1000), 512: (1, 5),
        777: (1, 5, 1000), 4097: (1, 5)}


@pytest.fixture(scope="module")
def lib():
    if not gxx_shim.available():
        pytest.skip("no g++ on PATH: the host build of the samplers needs it")
    return gxx_shim.load(gxx_shim.build_samplers())


def _streams(rows, n):
    """``rows`` streams of seed 2026, every third one's counter set to
    cross 2**32 at sample n // 2 + 1 of its row."""
    st = bits.initialize(2026, torch.arange(rows), device="cpu")
    wrap = torch.arange(rows) % 3 == 0
    return st._replace(ctr_lo=torch.where(wrap, 2**32 - 1 - n // 2,
                                          st.ctr_lo))


@pytest.mark.parametrize("n", sorted(ROWS))
@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("name", ["exponential_block", "normal_block",
                                  "exponential_block_zig"])
def test_host_built_sampler_matches_plain(lib, name, prof, n):
    plain = getattr(block_kernels, f"{name}_plain")
    with config.profile(prof):
        for rows in ROWS[n]:
            st = _streams(rows, n)
            ks, kx = gxx_shim.block(lib, name, st, n)
            ps, px = plain(st, n)
            what = f"{name} {prof} R={rows} n={n}"
            for a, b in zip(ks, ps):
                assert torch.equal(a, b), what
            assert kx.dtype == px.dtype and kx.shape == (rows, n), what
            assert bool(torch.isfinite(kx).all()), what
            tol = (BLOCK_TOL * torch.finfo(kx.dtype).eps
                   * px.abs().clamp(min=1.0))
            err = (kx - px).abs()
            assert bool((err <= tol).all()), (what, float(err.max()))
