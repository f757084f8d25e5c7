"""The port's time-weighted recording (stats/timeseries.py) against
cimba_tpu.stats.timeseries.

The same sequences (the reference's own test sequences of
tests/test_stats.py, and random ones made with numpy) go through both
packages' StepAccum and Timeseries in f64; every summary field must
agree within rtol 1e-12 of its scale (the two run the same operations;
the bound leaves room for XLA reassociating a sum).  A batch of lanes in
the port must equal the reference's sequences one lane at a time.
"""

import numpy as np
import pytest
import torch

from cimba_tpu.stats import summary as jsm
from cimba_tpu.stats import timeseries as jts
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch.stats import summary as tsm
from cimba_tpu_torch.stats import timeseries as tts

RTOL = 1e-12


def _close(ref, port):
    for name, a, b in zip(jsm.Summary._fields, ref, port):
        a = np.asarray(a, np.float64)
        b = b.detach().numpy().astype(np.float64)
        fin = np.isfinite(a)
        assert np.array_equal(fin, np.isfinite(b)), name
        assert np.array_equal(a[~fin], b[~fin]), name
        scale = max(float(np.abs(a[fin]).max()) if fin.any() else 0.0, 1.0)
        assert np.abs(a[fin] - b[fin]).max(initial=0.0) <= RTOL * scale, (
            name, a, b)


def _both(t0, v0, records, t_end, cap=64):
    """The reference's StepAccum and Timeseries over ``records`` (a list
    of (t, v)), and the port's, on the CPU in f64."""
    jacc = jts.step_create(t0, v0)
    jser = jts.add(jts.create(cap, t0=t0), t0, v0)
    for t, v in records:
        jacc = jts.step_record(jacc, t, v)
        jser = jts.add(jser, t, v)
    with tconfig.profile("f64"):
        tacc = tts.step_create(t0, v0, device="cpu")
        tser = tts.add(tts.create(cap, t0=t0, device="cpu"), t0, v0)
        for t, v in records:
            tacc = tts.step_record(tacc, t, v)
            tser = tts.add(tser, t, v)
    return (jacc, jser), (tacc, tser)


def test_time_weighted_mean_sequence():
    """Signal 0 on [0,2), 3 on [2,5), 1 on [5,10) (tests/test_stats.py)."""
    (jacc, jser), (tacc, tser) = _both(0.0, 0.0, [(2.0, 3.0), (5.0, 1.0)],
                                       10.0)
    _close(jts.step_finalize(jacc, 10.0), tts.step_finalize(tacc, 10.0))
    _close(jacc.summary, tacc.summary)
    _close(jts.summarize(jser, 10.0), tts.summarize(tser, 10.0))
    assert float(tts.step_finalize(tacc, 10.0).m1) == pytest.approx(1.4)
    assert bool(tacc.started) and float(tacc.last_v) == 1.0


def test_zero_duration_records():
    """A simultaneous re-record credits nothing (tests/test_stats.py)."""
    (jacc, _), (tacc, _) = _both(0.0, 1.0, [(0.0, 2.0), (4.0, 0.0)], 4.0)
    _close(jts.step_finalize(jacc, 4.0), tts.step_finalize(tacc, 4.0))
    assert float(tts.step_finalize(tacc, 4.0).m1) == 2.0
    assert float(tts.step_finalize(tacc, 4.0).w) == 4.0


@pytest.mark.parametrize("seed", [7, 11, 2026])
def test_random_sequences(seed):
    """Exponential gaps (some zero) and integer levels, as a queue's
    length is recorded; a series that overflows its capacity drops."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0, size=50) * (rng.random(50) > 0.2)
    times = np.cumsum(gaps)
    vals = rng.integers(0, 5, size=50).astype(float)
    t_end = float(times[-1] + 2.0)
    recs = list(zip(times[1:].tolist(), vals[1:].tolist()))
    (jacc, jser), (tacc, tser) = _both(float(times[0]), float(vals[0]),
                                       recs, t_end, cap=40)
    _close(jacc.summary, tacc.summary)
    _close(jts.step_finalize(jacc, t_end), tts.step_finalize(tacc, t_end))
    _close(jts.summarize(jser, t_end), tts.summarize(tser, t_end))
    assert int(tser.n) == int(jser.n) == 40
    assert int(tser.dropped) == int(jser.dropped) == 10
    np.testing.assert_array_equal(np.asarray(jts.durations(jser, t_end)),
                                  tts.durations(tser, t_end).numpy())


def test_lane_batched_records_equal_per_lane_reference():
    """The port's accumulators and series are lane-batched: 6 lanes with
    their own sequences, each lane equal to the reference run alone."""
    rng = np.random.default_rng(3)
    lanes, n, t_end = 6, 30, 40.0
    times = np.cumsum(rng.exponential(1.0, size=(lanes, n)), axis=1)
    vals = rng.integers(0, 7, size=(lanes, n)).astype(float)
    with tconfig.profile("f64"):
        acc = tts.step_create(0.0, 0.0, (lanes,), device="cpu")
        ser = tts.create(n, t0=0.0, shape=(lanes,), device="cpu")
        for j in range(n):
            t = torch.from_numpy(times[:, j])
            v = torch.from_numpy(vals[:, j])
            acc = tts.step_record(acc, t, v)
            ser = tts.add(ser, t, v)
        fin = tts.step_finalize(acc, t_end)
        summ = tts.summarize(ser, t_end)
    for lane in range(lanes):
        jacc, jser = jts.step_create(0.0, 0.0), jts.create(n, t0=0.0)
        for j in range(n):
            jacc = jts.step_record(jacc, times[lane, j], vals[lane, j])
            jser = jts.add(jser, times[lane, j], vals[lane, j])
        _close(jts.step_finalize(jacc, t_end),
               tsm.Summary(*[x[lane] for x in fin]))
        _close(jts.summarize(jser, t_end),
               tsm.Summary(*[x[lane] for x in summ]))


def test_f32_profile_dtypes_and_values():
    """Under the f32 profile the accumulator is f32 throughout and within
    f32 roundoff of the reference's f32 run."""
    from cimba_tpu import config as jconfig

    recs = [(1.0, 2.0), (1.5, 4.0), (3.25, 1.0), (3.25, 0.0), (7.0, 3.0)]
    with jconfig.profile("f32"):
        jacc = jts.step_create(0.0, 1.0)
        for t, v in recs:
            jacc = jts.step_record(jacc, t, v)
        jfin = jts.step_finalize(jacc, 9.0)
    with tconfig.profile("f32"):
        tacc = tts.step_create(0.0, 1.0, device="cpu")
        for t, v in recs:
            tacc = tts.step_record(tacc, t, v)
        tfin = tts.step_finalize(tacc, 9.0)
    assert all(x.dtype == torch.float32
               for x in (*tacc.summary, tacc.last_t, tacc.last_v))
    for a, b in zip(jfin, tfin):
        np.testing.assert_allclose(float(b), float(a), rtol=2e-6)
