"""ParticleFilter (Rodinia): track an object through noisy video frames
(counterpart of ``repro/apps/particlefilter.py``).

Accurate path: bootstrap particle filter — propagate, reweight by frame
likelihood, systematic resample, estimate.  It is itself an *algorithmic
approximation* whose RMSE floor is set by measurement noise — the paper's
Observation 1 benchmark (a CNN surrogate beats it on both speed and
accuracy).  QoI: object (x, y) per frame.  Metric: RMSE.

The reference draws the filter's noise from ``jax.random`` keys, a
stream torch cannot repeat.  So :func:`pf_step` takes its noise as
tensors, and :func:`track` draws them from a seeded ``torch.Generator``:
the same filter on another stream of noise.  Resampling indices are
clamped to the last particle, as a JAX gather clamps an index that
``searchsorted`` puts past the end.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import approx_ml, tensor_functor
from repro_torch.device import resolve_device

H = W = 24
N_PART = 256
NOISE = 0.35

frame_fn = tensor_functor(f"pf_in: [i, 0:{H * W}] = ([i, 0:{H * W}])")
loc_fn = tensor_functor("pf_out: [i, 0:2] = ([i, 0:2])")


def make_video(n_frames, seed=0, device=None):
    """Returns (frames [T, H, W], truth [T, 2])."""
    rng = np.random.default_rng(seed)
    pos = np.array([H * 0.3, W * 0.3])
    vel = np.array([0.7, 0.5])
    frames, truth = [], []
    yy, xx = np.mgrid[0:H, 0:W]
    for _ in range(n_frames):
        pos = pos + vel + rng.normal(0, 0.15, 2)
        vel = vel * 0.99 + rng.normal(0, 0.05, 2)
        pos = np.clip(pos, 2, H - 3)
        vel = np.where((pos <= 2) | (pos >= H - 3), -vel, vel)
        img = np.exp(-((yy - pos[0]) ** 2 + (xx - pos[1]) ** 2) / 6.0)
        img = img + rng.normal(0, NOISE, img.shape)
        frames.append(img.astype(np.float32))
        truth.append(pos.copy())
    dev = resolve_device(device)
    return (torch.from_numpy(np.stack(frames)).to(dev),
            torch.from_numpy(np.stack(truth).astype(np.float32)).to(dev))


def pf_step(parts, vels, frame, vel_noise, part_noise, offset):
    """One filter step on one frame, given its noise: ``vel_noise`` and
    ``part_noise`` standard normal [N_PART, 2], ``offset`` uniform in
    [0, 1) (0-d).  Returns ``(parts, vels, est)``."""
    vels = vels * 0.95 + vel_noise * 0.12
    parts = torch.clamp(parts + vels + part_noise * 0.35, 0, H - 1)
    iy = torch.clamp(parts[:, 0].to(torch.int32), 1, H - 2).long()
    ix = torch.clamp(parts[:, 1].to(torch.int32), 1, W - 2).long()
    # 3x3 patch likelihood (template = bright blob center)
    patch = sum(frame[iy + dy, ix + dx]
                for dy in (-1, 0, 1) for dx in (-1, 0, 1)) / 9.0
    w = torch.softmax(patch * 24.0, 0)
    est = (w[:, None] * parts).sum(0)
    # systematic resampling
    cum = torch.cumsum(w, 0)
    u = (offset + torch.arange(N_PART, device=parts.device)) / N_PART
    idx = torch.searchsorted(cum, u).clamp_(max=N_PART - 1)
    return parts[idx], vels[idx], est


def track(frames, seed=0):
    """Accurate path: [T, H, W] frames -> [T, 2] estimates."""
    dev = frames.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t = frames.shape[0]
    parts = torch.full((N_PART, 2), H * 0.3, device=dev) + \
        torch.randn((N_PART, 2), generator=gen, device=dev) * 2.0
    vels = torch.zeros((N_PART, 2), device=dev)
    noise = torch.randn((t, 2, N_PART, 2), generator=gen, device=dev)
    offsets = torch.rand((t,), generator=gen, device=dev)
    ests = []
    for i in range(t):
        parts, vels, est = pf_step(parts, vels, frames[i], noise[i, 0],
                                   noise[i, 1], offsets[i])
        ests.append(est)
    return torch.stack(ests)


def accurate(frames):
    return {"loc": track(frames)}


def make_region(n_frames, mode="collect", model=None, database=None,
                device=None):
    """Region input is the flattened video [T, H*W] (tensor-space layout)."""
    rngs = {"i": (0, n_frames)}
    return approx_ml(
        lambda frames: {"loc": track(frames.reshape(-1, H, W))},
        name="particlefilter",
        inputs={"frames": (frame_fn, rngs)},
        outputs={"loc": (loc_fn, rngs)},
        mode=mode, model=model, database=database, device=device)


def qoi_error(truth, est):
    t = torch.as_tensor(truth).detach().cpu().numpy().reshape(-1, 2)
    e = torch.as_tensor(est).detach().cpu().numpy().reshape(-1, 2)
    return float(np.sqrt(np.mean(np.sum((t - e) ** 2, axis=1))))


def surrogate_space():
    return {"kind": "cnn", "grid": (H, W), "in_ch": 1, "out_ch": 2,
            "conv_k": (2, 8), "stride": (1, 4), "pool": (1, 4),
            "fc2": (0, 128)}
