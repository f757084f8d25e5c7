"""The plain versions of the bulk samplers K2-K4 against cimba_tpu (CPU).

The JAX kernels run in interpret mode, as tests/test_pallas_kernels.py
runs them.  Counter states are always equal.  Values, as k eps of
max(|x|, 1), measured on these streams and bounded with headroom:

* f64, against the JAX kernels: K2 64 (bound 128; XLA's f64 log1p is
  off by up to 128 ulp), K3 14.5 (bound 32; the log1p inside erf_inv),
  K4 0.016 (bound 1; only its rare tail and fallback take a log1p).
* f32, against the JAX *sequential* f32 samplers (``std_exponential``,
  ``std_normal``), which the JAX f32 kernels do not equal: K2 1, K3 2
  (bounds 2 and 4, as test_torch_samplers.py).  K4 against the JAX f32
  kernel on every sample that took neither the tail nor the fallback:
  equal.  The moments hold for all samples.

The plain blocks equal the port's own sequential draws exactly, in both
profiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cimba_tpu.random as cr
from cimba_tpu import config as jconfig
from cimba_tpu.random import pallas_kernels as pk
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch.random import bits as tbits
from cimba_tpu_torch.random import block_kernels as bk
from cimba_tpu_torch.random import distributions as tdist

SHAPES = [(8, 64), (64, 256)]
WRAP = 0xFFFFFF00


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    at once, and torch's thread pools in each of them would contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _streams(seed, rows, wrap=False):
    js = jax.vmap(lambda r: cr.initialize(seed, r))(jnp.arange(rows))
    ts = tbits.initialize(seed, torch.arange(rows), device="cpu")
    if wrap:  # every other stream's counter crosses 2**32 in the block
        lo = np.where(np.arange(rows) % 2 == 0, WRAP, 0).astype(np.uint32)
        js = js._replace(ctr_lo=jnp.asarray(lo))
        ts = ts._replace(ctr_lo=torch.from_numpy(lo.astype(np.int64)))
    return js, ts


def _same_states(js, ts):
    for w, g in zip(js, ts):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64),
                                      g.numpy())


def _k(x, y):
    x, y = np.asarray(x), y.numpy()
    assert x.dtype == y.dtype and np.isfinite(y).all()
    return (np.abs(x - y) / np.maximum(np.abs(x), 1.0)
            / np.finfo(x.dtype).eps).max()


def _sequential(draw, states, n):
    def chain(st, _):
        return draw(st)

    return jax.vmap(lambda s: jax.lax.scan(chain, s, None, length=n))(states)


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("rows,n", SHAPES)
@pytest.mark.parametrize("jfn,tfn,k", [
    (pk.exponential_block, bk.exponential_block, 128),
    (pk.normal_block, bk.normal_block, 32),
    (pk.exponential_block_zig, bk.exponential_block_zig, 1),
], ids=["K2", "K3", "K4"])
def test_f64_blocks_match_jax_kernels(jfn, tfn, k, rows, n, wrap):
    with jconfig.profile("f64"), tconfig.profile("f64"):
        js, ts = _streams(5, rows, wrap)
        js2, x = jfn(js, n, interpret=True)
        ts2, y = tfn(ts, n)
    _same_states(js2, ts2)
    assert _k(x, y) <= k


@pytest.mark.parametrize("rows,n", SHAPES)
@pytest.mark.parametrize("name,tfn,k", [
    ("std_exponential", bk.exponential_block, 2),
    ("std_normal", bk.normal_block, 4),
], ids=["K2", "K3"])
def test_f32_blocks_match_jax_sequential_samplers(name, tfn, k, rows, n):
    with jconfig.profile("f32"), tconfig.profile("f32"):
        js, ts = _streams(11, rows, wrap=True)
        js2, x = _sequential(getattr(cr, name), js, n)
        ts2, y = tfn(ts, n)
    _same_states(js2, ts2)
    assert _k(x, y) <= k


def test_f32_zig_block_matches_jax_kernel_off_the_tails():
    rows, n = 256, 128
    with jconfig.profile("f32"), tconfig.profile("f32"):
        js, ts = _streams(3, rows, wrap=True)
        js2, x = pk.exponential_block_zig(js, n, interpret=True)
        ts2, y = bk.exponential_block_zig(ts, n)
        _, _, path = bk._exp_zig_plain(ts, n)
    _same_states(js2, ts2)
    keep = ~np.isin(path.numpy(), bk.ZIG_INVERTED)
    assert keep.mean() > 0.99
    np.testing.assert_array_equal(np.asarray(x)[keep], y.numpy()[keep])
    v = y.numpy().astype(np.float64).ravel()
    assert np.isfinite(v).all() and v.min() >= 0.0
    assert abs(v.mean() - 1.0) < 0.02
    assert abs(v.var() - 1.0) < 0.05
    assert abs(((v - v.mean()) ** 3).mean() / v.std() ** 3 - 2.0) < 0.15


@pytest.mark.parametrize("prof", ["f64", "f32"])
@pytest.mark.parametrize("draw,block", [
    (tdist.std_exponential, bk.exponential_block),
    (tdist.std_normal, bk.normal_block),
], ids=["K2", "K3"])
def test_plain_blocks_equal_own_sequential_draws(draw, block, prof):
    rows, n = 32, 96
    with tconfig.profile(prof):
        _, ts = _streams(7, rows, wrap=True)
        st, cols = ts, []
        for _ in range(n):
            st, x = draw(st)
            cols.append(x)
        ts2, y = block(ts, n)
    _same_states(st, ts2)
    assert torch.equal(torch.stack(cols, 1), y)


def test_advance_and_its_carry():
    st = tbits.RandomState(*[torch.tensor([1, 2]), torch.tensor([3, 4]),
                             torch.tensor([WRAP, 5]),
                             torch.tensor([0xFFFFFFFF, 9])])
    got = bk._advance(st, 0x100)
    assert got.ctr_lo.tolist() == [0, 0x105]
    assert got.ctr_hi.tolist() == [0, 9]  # the carry wraps the high word
    assert got.key0 is st.key0 and got.key1 is st.key1
    js = jax.vmap(pk._advance, in_axes=(0, None))(
        cr.RandomState(*[jnp.asarray(x.numpy(), jnp.uint32) for x in st]),
        0x100)
    _same_states(js, got)


def test_block_samplers_check_their_inputs():
    _, ts = _streams(1, 4)
    for bad in (0, -3, 1.5):
        with pytest.raises(ValueError):
            bk.exponential_block(ts, bad)
    with pytest.raises(ValueError):
        bk.exponential_block_zig(ts, 2**32 // 5 + 1)
    with pytest.raises(ValueError):
        bk.normal_block(tbits.initialize(1, torch.arange(4).reshape(2, 2),
                                         device="cpu"), 8)
