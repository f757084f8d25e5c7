"""AWACS radar scenario (torch port of :mod:`cimba_tpu.models.awacs`, same
constants, blocks, draws and commands).

Many target processes fly straight legs with random turn points; one
sensor process wakes every dwell and scores all targets for detection —
the reference's tutorial 5 (`tut_5_1.c` on the CPU, `tut_5_3.c` with the
physics launched as CUDA kernels from inside the coroutine).

Targets are pids ``0..n_targets-1`` (block ``tgt_leg``), the sensor is pid
``n_targets`` at priority 1 (block ``sensor_dwell``).  The state is the
user columns ``pos_x/pos_y/vel_x/vel_y/t_mark`` ``[L, n_targets]``,
updated lazily at leg ends: the sensor extrapolates ``pos + vel * (t -
t_mark)``.

``sensor_dwell`` is a boundary block: on the card the AWACS chunk kernel
(``csrc/awacs_chunk.cu``) runs the target legs and freezes a lane whose
next dispatch is the sensor, and the host loop runs that dispatch
between chunks as one launch of the dwell kernel of the same file, which
computes this block (features and, with ``scoring="nn"``, the detection
MLP) for every target of every frozen lane.  The standalone MLP, K5
(``csrc/nn_scores.cu``, :func:`nn_forward`), serves :func:`nn_scores`,
and so the plain engine's dwell on the card.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

import cimba_tpu_torch.random as cr
from cimba_tpu_torch import config
from cimba_tpu_torch.config import INDEX
from cimba_tpu_torch.core import api, ix
from cimba_tpu_torch.core import process as cmd
from cimba_tpu_torch.core.model import Model
from cimba_tpu_torch.stats import summary as sm

ARENA = 100.0          # square arena half-size
SPEED = 5.0            # target speed
LEG_MEAN = 4.0         # mean straight-leg duration
DETECT_RANGE = 40.0    # sensor detection radius
DWELL = 0.04 * 25      # dwell interval (scaled tut_5 pattern)

# --- NN detection scorer: fixed weights (a deterministic stand-in for a
# trained radar-SNR model), two hidden layers and a skip connection of
# weight 8 on the range-gaussian feature, as in the reference.

_NN_F = 8    # features per target
_NN_H = 32   # hidden width


def _make_nn_weights():
    """(w1 [8,32], b1 [32], w2 [32,32], b2 [32], w3 [33,1], b3 [1]), f32
    numpy arrays drawn exactly as the reference draws them."""
    rng = np.random.default_rng(20260729)

    def glorot(shape):
        lim = np.sqrt(6.0 / (shape[0] + shape[1]))
        return rng.uniform(-lim, lim, shape).astype(np.float32)

    w1 = glorot((_NN_F, _NN_H))
    b1 = np.zeros(_NN_H, np.float32)
    w2 = glorot((_NN_H, _NN_H))
    b2 = np.zeros(_NN_H, np.float32)
    w3 = np.concatenate(
        [0.3 * glorot((_NN_H, 1)), np.full((1, 1), 8.0, np.float32)]
    )
    b3 = np.full(1, -2.0, np.float32)
    return (w1, b1, w2, b2, w3, b3)


_NN_WEIGHTS = _make_nn_weights()
#: device -> the weights as f32 tensors there, and packed for K5
_ON_DEVICE: dict = {}


def _weights(device):
    """``(tensors, packed)``: the six weight tensors on ``device`` and
    their concatenation in K5's order (w1, b1, w2, b2, w3, b3)."""
    if device not in _ON_DEVICE:
        ts = tuple(torch.from_numpy(a).to(device) for a in _NN_WEIGHTS)
        _ON_DEVICE[device] = (ts, torch.cat([t.reshape(-1) for t in ts]))
    return _ON_DEVICE[device]


def _nn_features(pos, vel):
    """[M,2],[M,2] -> ([M,8] f32 features, [M] f32 range gaussian)."""
    pos = pos.to(torch.float32)
    vel = vel.to(torch.float32)
    r2 = (pos * pos).sum(dim=1)
    g = torch.exp(-r2 / (DETECT_RANGE**2))
    radial = (pos * vel).sum(dim=1) / (SPEED * DETECT_RANGE)
    feats = torch.stack(
        [
            pos[:, 0] / ARENA,
            pos[:, 1] / ARENA,
            r2 / (ARENA**2),
            g,
            vel[:, 0] / SPEED,
            vel[:, 1] / SPEED,
            radial,
            torch.ones_like(g),
        ],
        dim=1,
    )
    return feats, g


def nn_forward_plain(feats, g):
    """Plain version of K5, the reference's ``_nn_forward``: [M,8] f32
    features and [M] range gaussian -> [M] detection probability."""
    (w1, b1, w2, b2, w3, b3), _ = _weights(feats.device)
    h1 = torch.relu(feats @ w1 + b1)
    h2 = torch.relu(h1 @ w2 + b2)
    h2g = torch.cat([h2, g[:, None]], dim=1)
    logit = h2g @ w3 + b3
    return torch.sigmoid(logit[:, 0])


_K5 = []  # the bound C entry, once loaded


def nn_forward(feats, g):
    """The detection MLP (K5).  On CUDA tensors one launch of the kernel
    of ``csrc/nn_scores.cu`` for all M rows (``nn_forward.launches``
    counts launches); on CPU tensors its plain version.  A failed build
    or launch raises."""
    if not feats.is_cuda:
        return nn_forward_plain(feats, g)
    from cimba_tpu_torch import _build

    m = feats.shape[0]
    if (feats.dtype != torch.float32 or tuple(feats.shape) != (m, _NN_F)
            or g.dtype != torch.float32 or tuple(g.shape) != (m,)
            or g.device != feats.device):
        raise ValueError(f"K5 takes f32 feats [M, {_NN_F}] and g [M] on one "
                         f"device, got {feats.dtype} {tuple(feats.shape)} "
                         f"and {g.dtype} {tuple(g.shape)}")
    if not _K5:
        fn = _build.load("nn_scores").cimba_nn_scores
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64,
                                               ctypes.c_void_p]
        _K5.append(fn)
    feats, g = feats.contiguous(), g.contiguous()
    _, packed = _weights(feats.device)
    out = torch.empty((m,), dtype=torch.float32, device=feats.device)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _K5[0](feats.data_ptr(), g.data_ptr(), packed.data_ptr(),
                    out.data_ptr(), m, stream)
    if rc != 0:
        raise RuntimeError(f"nn_scores kernel launch failed (code {rc})")
    nn_forward.launches += 1
    return out


nn_forward.launches = 0


def nn_scores_plain(pos, vel):
    """Detection probabilities [M] for targets at ``pos`` [M,2] moving
    at ``vel`` [M,2], the plain version throughout."""
    feats, g = _nn_features(pos, vel)
    return nn_forward_plain(feats, g)


def nn_scores(pos, vel):
    """Detection probabilities [M] — the physics hook: the features in
    torch, then K5 on the card (the plain version on the CPU).  Always
    f32, whatever the profile, as in the reference."""
    feats, g = _nn_features(pos, vel)
    return nn_forward(feats, g)


def build(n_targets: int, scoring: str = "nn"):
    """``scoring="nn"`` (default) scores with the MLP, K5 on the card;
    ``"threshold"`` with the closed-form linear falloff of tut_5_1."""
    if scoring not in ("nn", "threshold"):
        raise ValueError(f"scoring must be 'nn' or 'threshold': {scoring}")
    # the general event table holds only timers and user events, which
    # this model never schedules: a token capacity, as in the reference
    m = Model("awacs", event_cap=8, guard_cap=2)

    @m.user_state
    def user_init(params):
        (t_end,) = params
        real = config.real()
        shape, dev = t_end.shape, t_end.device

        def cols():
            return torch.zeros(shape + (n_targets,), dtype=real, device=dev)

        return {
            "t_end": t_end.to(real),
            "pos_x": cols(),
            "pos_y": cols(),
            "vel_x": cols(),
            "vel_y": cols(),
            "t_mark": cols(),
            "detections": sm.empty(shape, dev, real),  # per-dwell counts
            "dwells": torch.zeros(shape, dtype=INDEX, device=dev),
        }

    @m.block
    def tgt_leg(sim, p, sig):
        """Start a new straight leg: random heading, exponential duration."""
        u = sim.user
        # target index within the type (targets are pids 0..N-1); a lane
        # whose subject is the sensor computes this block too and drops
        # it, so its index is clamped into the columns
        idx = p.clamp(max=n_targets - 1)
        # fold the position forward to now, then draw a new velocity
        t_mark, vel_x, vel_y, pos_x, pos_y = ix.get_tree(
            (u["t_mark"], u["vel_x"], u["vel_y"], u["pos_x"], u["pos_y"]),
            idx)
        dt = sim.clock - t_mark
        px = pos_x + vel_x * dt
        py = pos_y + vel_y * dt
        # soft bounce: outside the arena, head back toward the center
        sim, heading = api.draw(sim, cr.uniform, 0.0, 2.0 * math.pi)
        r = torch.sqrt(px * px + py * py)
        outside = r > ARENA
        inv_r = 1.0 / torch.clamp(r, min=1e-6)
        vx = SPEED * torch.where(outside, -px * inv_r, torch.cos(heading))
        vy = SPEED * torch.where(outside, -py * inv_r, torch.sin(heading))
        w_pos_x, w_pos_y, w_vel_x, w_vel_y, w_t_mark = ix.put_tree(
            (u["pos_x"], u["pos_y"], u["vel_x"], u["vel_y"], u["t_mark"]),
            idx, (px, py, vx, vy, sim.clock))
        sim = api.set_user(sim, {
            **u, "pos_x": w_pos_x, "pos_y": w_pos_y, "vel_x": w_vel_x,
            "vel_y": w_vel_y, "t_mark": w_t_mark})
        sim, leg = api.draw(sim, cr.exponential, LEG_MEAN)
        done = sim.clock >= sim.user["t_end"]
        return sim, cmd.select(done, cmd.exit_(),
                               cmd.hold(leg, next_pc=tgt_leg.pc))

    @m.boundary_block
    def sensor_dwell(sim, p, sig):
        """One radar dwell: detection over all targets, plus one uniform
        draw for the whole dwell (scan noise)."""
        u = sim.user
        dt = sim.clock[:, None] - u["t_mark"]
        px = u["pos_x"] + u["vel_x"] * dt
        py = u["pos_y"] + u["vel_y"] * dt
        sim, noise = api.draw(sim, cr.uniform01)
        if scoring == "nn":
            pos = torch.stack([px, py], dim=2).reshape(-1, 2)
            vel = torch.stack([u["vel_x"], u["vel_y"]], dim=2).reshape(-1, 2)
            p_det = nn_scores(pos, vel).reshape(px.shape).to(px.dtype)
        else:
            r2 = px * px + py * py
            p_det = torch.clamp(1.2 - torch.sqrt(r2) / DETECT_RANGE, 0.0,
                                1.0)
        detected = (p_det > noise[:, None]).to(px.dtype).sum(dim=1)
        sim = api.set_user(sim, {
            **u,
            "detections": sm.add(u["detections"], detected),
            "dwells": u["dwells"] + 1,
        })
        done = sim.clock >= sim.user["t_end"]
        sim = api.stop(sim, done)
        return sim, cmd.select(done, cmd.exit_(),
                               cmd.hold(DWELL, next_pc=sensor_dwell.pc))

    # the dwell kernel (csrc/awacs_chunk.cu) computes the scoring itself
    sensor_dwell.scoring = scoring
    m.process("target", entry=tgt_leg, count=n_targets)  # pids 0..N-1
    m.process("sensor", entry=sensor_dwell, prio=1)      # pid N
    return m.build(), {}


def params(t_end: float):
    return (t_end,)


#: names of the blocks above, in pc order — the AWACS chunk kernel
#: (csrc/awacs_chunk.cu) hard-codes tgt_leg and checks a spec against them
BLOCK_NAMES = ("tgt_leg", "sensor_dwell")
