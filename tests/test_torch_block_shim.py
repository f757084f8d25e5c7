"""The bulk samplers K2-K4 built with g++ on the CPU, against their plain
versions.

``cimba_tpu_torch.tools.gxx_shim.build_samplers`` builds
``csrc/bulk_samplers.cu`` for the host (a stand-in for ``cuda_runtime.h``,
each launch run as a loop over the grid of 3 SMs x 1 block; K4's blocks as
fibers that take turns at its ``__syncthreads()`` and at each warp call,
so that its warps' ballots and queues of round-1 misses run as on the
card).  K2 (the exponential
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

The shim runs each thread of K2 and K3 as a warp of its own.  K3's warp vote
(``__all_sync(__activemask(), w in the central branch)``) is then the
lane's own predicate, which is exact in value since both paths compute
the same value.  The f64 kernels' exchange of log1p arguments between the
lanes of a whole warp (``log1p_run``) never runs here (no warp is whole):
each lane computes its own, and the exchange is held against the plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 5).  K4 is held further: each of its paths taken (hot, wedge and
tail in both rounds, the fallback) over 1000 x 777 samples; rows of one
sample, odd n, a part-full last warp and an output view off 16 bytes;
and a warp queue cut to 1 or 3 entries, so that misses find it full.
Its samples off the libm paths (both rounds' hot tests) must equal the
plain version's bit for bit.  Every test skips where there is no
``g++``; torch runs on one thread.
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


# --- K4's warp gather: the shim's fibers exchange a warp's ballots as
# the card's lanes do (gxx_shim.shim_launch_block), so the queue of
# round-1 misses, its flushes and its overflow run here as on the card

def _zig_case(lib, prof, rows, n, out=None):
    """K4 host-built and plain on the same streams: (kernel samples,
    plain samples, paths), the counters checked equal."""
    with config.profile(prof):
        st = _streams(rows, n)
        ks, kx = gxx_shim.block(lib, "exponential_block_zig", st, n, out=out)
        px, _, path = block_kernels._exp_zig_plain(st, n)
        ps, _ = block_kernels.exponential_block_zig_plain(st, n)
    for a, b in zip(ks, ps):
        assert torch.equal(a, b), (prof, rows, n)
    return kx, px, path


def _assert_zig_equal(kx, px, path, what):
    """Every sample within BLOCK_TOL; those whose path takes no libm call
    (round 1's or round 2's hot test) bit for bit."""
    assert kx.dtype == px.dtype and kx.shape == px.shape, what
    tol = BLOCK_TOL * torch.finfo(kx.dtype).eps * px.abs().clamp(min=1.0)
    err = (kx - px).abs()
    assert bool((err <= tol).all()), (what, float(err.max()))
    hot = (path == block_kernels.ZIG_PATHS.index("hot")) | (
        path == block_kernels.ZIG_PATHS.index("hot2"))
    assert torch.equal(kx[hot], px[hot]), what


@pytest.mark.parametrize("prof", ["f32", "f64"])
def test_host_built_zig_takes_every_path(lib, prof):
    """K4 over 1000 x 777 samples: the plain version takes each of its
    paths (hot, wedge, tail, in both rounds, and the fallback), and the
    host-built kernel agrees on them all."""
    kx, px, path = _zig_case(lib, prof, 1000, 777)
    counts = torch.bincount(path.flatten().long(),
                            minlength=len(block_kernels.ZIG_PATHS))
    assert int(counts.min()) > 0, counts.tolist()
    _assert_zig_equal(kx, px, path, prof)


@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("rows,n", [(1, 1), (7, 1), (5, 9), (3, 13),
                                    (33, 31), (2, 4097)])
def test_host_built_zig_edge_shapes(lib, prof, rows, n):
    """Rows of one sample, runs that leave the grid's last warp part
    full (rows x runs not a multiple of 32), odd n, and an output view
    one element off 16 bytes (no vector stores)."""
    kx, px, path = _zig_case(lib, prof, rows, n)
    _assert_zig_equal(kx, px, path, (prof, rows, n))
    real = torch.float32 if prof == "f32" else torch.float64
    base = torch.full((rows * n + 1,), float("nan"), dtype=real)
    view = base[1:].view(rows, n)
    kx, px, path = _zig_case(lib, prof, rows, n, out=view)
    assert bool(torch.isnan(base[0])), "a store before the view"
    _assert_zig_equal(kx, px, path, (prof, rows, n, "offset view"))


@pytest.mark.parametrize("queue", [1, 3])
@pytest.mark.parametrize("prof", ["f32", "f64"])
def test_host_built_zig_full_queue(prof, queue):
    """K4 with its warp's queue cut to 1 or 3 entries: the misses that
    find it full wait in their lanes and are queued again after the
    run's store (zig_overflow); every sample still agrees."""
    if not gxx_shim.available():
        pytest.skip("no g++ on PATH: the host build of the samplers needs it")
    src = (gxx_shim._build.CSRC / "bulk_samplers.cu").read_text()
    line = "constexpr unsigned kZigQueue = 64;"
    assert line in src
    small = gxx_shim.load(gxx_shim.build_samplers(
        source=src.replace(line, f"constexpr unsigned kZigQueue = {queue};")))
    for rows, n in ((40, 257), (3, 1000)):
        kx, px, path = _zig_case(small, prof, rows, n)
        _assert_zig_equal(kx, px, path, (prof, queue, rows, n))
