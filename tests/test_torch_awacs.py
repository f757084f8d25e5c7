"""The port's AWACS model (models/awacs.py) against cimba_tpu's: the NN
scorer's weights and arithmetic, and the seed-pinned golden run.

The scorer is f32 in both packages.  Its plain version and the
reference's (``use_pallas=False``, and the Pallas kernel in interpret
mode) sum the same products in another order, so they are held to f32
roundoff as the reference holds its own kernel (tests/test_models.py):
rtol = atol = 1e-6.  The CUDA kernel K5 is tested on the card
(test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cimba_tpu.models import awacs as jawacs
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.models import awacs

# tests/test_golden.py, "awacs": awacs.build(8), seed 777, replication 13,
# t_end 200 -> (clock, n_events, detections m1, m2, mn, mx)
GOLDEN = (200.0, 596, 2.6716417910447765, 1450.3283582089562, 0.0, 8.0)


def _ref_weights():
    return [np.asarray(w) for w in jawacs._NN_WEIGHTS]


def test_weights_equal_the_reference_bit_for_bit():
    for ours, ref in zip(awacs._NN_WEIGHTS, _ref_weights()):
        assert ours.dtype == ref.dtype == np.float32
        assert ours.shape == ref.shape
        assert ours.tobytes() == ref.tobytes()


def test_nn_weights_from_numpy_round_trips():
    ref = _ref_weights()
    ts = interop.nn_weights_from_numpy(*ref, device="cpu")
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in ts)
    assert all(t.numpy().tobytes() == r.tobytes() for t, r in zip(ts, ref))
    ours, _ = awacs._weights(torch.device("cpu"))
    assert all(torch.equal(a, b) for a, b in zip(ts, ours))
    with pytest.raises(ValueError, match="float32"):
        interop.nn_weights_from_numpy(
            *(ref[:5] + [np.repeat(ref[5], 2)]), device="cpu")
    with pytest.raises(ValueError, match="float32"):
        interop.nn_weights_from_numpy(
            *([ref[0].astype(np.float64)] + ref[1:]), device="cpu")


def test_nn_scores_match_reference_and_pallas_interpret():
    rng = np.random.default_rng(7)
    n = 137  # as the reference's test: not a multiple of 128
    pos = rng.uniform(-80, 80, (n, 2))
    vel = rng.normal(0, awacs.SPEED, (n, 2))
    ref = np.asarray(jawacs.nn_scores(jnp.asarray(pos), jnp.asarray(vel),
                                      use_pallas=False))
    ker = np.asarray(jawacs.nn_scores(jnp.asarray(pos), jnp.asarray(vel),
                                      use_pallas=True, interpret=True))
    before = awacs.nn_forward.launches
    ours = awacs.nn_scores(torch.from_numpy(pos), torch.from_numpy(vel))
    plain = awacs.nn_scores_plain(torch.from_numpy(pos),
                                  torch.from_numpy(vel))
    assert awacs.nn_forward.launches == before  # CPU: no kernel launch
    assert ours.dtype == torch.float32 and ours.shape == (n,)
    assert torch.equal(ours, plain)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours.numpy(), ker, rtol=1e-6, atol=1e-6)
    feats, g = awacs._nn_features(torch.from_numpy(pos),
                                  torch.from_numpy(vel))
    jf, jg = jawacs._nn_features(jnp.asarray(pos), jnp.asarray(vel))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jf), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)


def test_center_outscores_far():
    """Physically sensible without training (tests/test_models.py)."""
    zeros = torch.zeros((1, 2), dtype=torch.float64)
    center = float(awacs.nn_scores(zeros, zeros)[0])
    far = float(awacs.nn_scores(torch.full((1, 2), 90.0,
                                           dtype=torch.float64), zeros)[0])
    assert center > 0.9 and far < 0.3 and center > 2 * far


def test_golden_run():
    spec, _ = awacs.build(8)
    sim = tloop.make_run(spec)(tloop.init_sim(
        spec, 777, torch.tensor([13]), awacs.params(200.0), device="cpu"))
    clock, n_events, m1, m2, mn, mx = GOLDEN
    assert int(sim.err[0]) == 0
    np.testing.assert_allclose(float(sim.clock[0]), clock, rtol=1e-12)
    assert int(sim.n_events[0]) == n_events
    d = sim.user["detections"]
    np.testing.assert_allclose(float(d.m1[0]), m1, rtol=1e-12)
    np.testing.assert_allclose(float(d.m2[0]), m2, rtol=1e-9)
    np.testing.assert_allclose(float(d.mn[0]), mn, rtol=1e-12)
    np.testing.assert_allclose(float(d.mx[0]), mx, rtol=1e-12)
    assert int(sim.user["dwells"][0]) == 201


def test_build_rejects_unknown_scoring():
    with pytest.raises(ValueError, match="scoring"):
        awacs.build(4, scoring="radar")
