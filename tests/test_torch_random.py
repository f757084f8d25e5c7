"""The port's Threefry streams and samplers against cimba_tpu.random.

Words, seeding and counters must be bit-identical.  The uniforms are
exact in both profiles.  The exponential goes through log1p, which
differs between the packages' libraries: torch's is within 1 ulp of
glibc in both profiles, XLA's f64 log1p is off by up to 129 ulp near
u = 0.41 (measured against glibc), so the f64 bound against the
reference is 256 ulp and the f32 bound 2 ulp.  Against glibc's log1p of
the reference's own (exact) uniforms the port's exponential is within
1 ulp in both profiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.random import bits as jbits
from cimba_tpu.random import distributions as jdist
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch.random import bits as tbits
from cimba_tpu_torch.random import distributions as tdist


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_threefry_kat_and_random_words():
    assert [int(x) for x in tbits.threefry2x32(*map(torch.tensor, (0, 0, 0, 0)))] \
        == [0x6B200159, 0x99BA4EFE]
    rng = np.random.default_rng(2026)
    k = rng.integers(0, 2**32, size=(4, 4096), dtype=np.uint64).astype(np.uint32)
    want = jbits.threefry2x32(*[jnp.asarray(x) for x in k])
    got = tbits.threefry2x32(*[_t(x) for x in k])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64), g.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2026, 2**63 + 5, 2**64 - 1])
def test_initialize_matches(seed):
    reps = np.array([0, 1, 7, 4095, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 1,
                     3 * 2**31], dtype=np.uint64)
    want = jax.vmap(lambda r: jbits.initialize(seed, r))(jnp.asarray(reps))
    got = tbits.initialize(seed, torch.from_numpy(reps.astype(np.int64)),
                           device="cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64), g.numpy())


def test_counter_carry_matches():
    st = jbits.RandomState(*[jnp.asarray(v, jnp.uint32) for v in
                             (1, 2, 0xFFFFFFFF, 7)])
    ts = tbits.RandomState(*[torch.tensor(v) for v in (1, 2, 0xFFFFFFFF, 7)])
    for _ in range(3):
        st, a0, a1 = jbits.next_bits64(st)
        ts, b0, b1 = tbits.next_bits64(ts)
        assert (int(a0), int(a1)) == (int(b0), int(b1))
        assert [int(x) for x in st] == [int(x) for x in ts]


def _ulps(a, b):
    it = np.int32 if a.dtype == np.float32 else np.int64
    return np.abs(a.view(it).astype(np.int64) - b.view(it).astype(np.int64))


@pytest.mark.parametrize("prof", ["f64", "f32"])
@pytest.mark.parametrize("name,ulps", [
    ("uniform01", 0), ("uniform01_53", 0), ("std_exponential", None),
    ("exponential", None),
])
def test_samplers_match(prof, name, ulps):
    if ulps is None:
        ulps = 256 if prof == "f64" else 2
    n = 20000
    with jconfig.profile(prof), tconfig.profile(prof):
        js = jax.vmap(lambda r: jbits.initialize(99, r))(jnp.arange(n))
        ts = tbits.initialize(99, torch.arange(n), device="cpu")
        args = (1.7,) if name == "exponential" else ()
        js2, x = jax.vmap(lambda s: getattr(jdist, name)(s, *args))(js)
        ts2, y = getattr(tdist, name)(ts, *args)
        x, y = np.asarray(x), y.numpy()
        assert x.dtype == y.dtype == (np.float32 if prof == "f32" else np.float64)
        assert _ulps(x, y).max() <= ulps
        # one counter tick per draw in both packages
        for w, g in zip(js2, ts2):
            np.testing.assert_array_equal(np.asarray(w).astype(np.int64),
                                          g.numpy())


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_exponential_within_one_ulp_of_libm(prof):
    """-log1p(-u) on the reference's uniforms, rounded by numpy (glibc)."""
    n = 20000
    with jconfig.profile(prof), tconfig.profile(prof):
        js = jax.vmap(lambda r: jbits.initialize(5, r))(jnp.arange(n))
        _, u = jax.vmap(jdist.uniform01_53)(js)
        _, y = tdist.std_exponential(
            tbits.initialize(5, torch.arange(n), device="cpu"))
    u = np.asarray(u)
    want = -np.log1p(-u)
    assert want.dtype == y.numpy().dtype
    assert _ulps(want, y.numpy()).max() <= 1
