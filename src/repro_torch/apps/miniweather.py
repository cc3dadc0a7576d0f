"""MiniWeather: 2-D atmospheric dynamics (advection + buoyancy + diffusion)
(counterpart of ``repro/apps/miniweather.py``).

State: [ny, nx, 4] = (density, x-momentum, y-momentum, potential temp).
The accurate timestep is a 5-point-stencil finite-volume update — the
exact shape of the paper's Fig. 2 example, and the app that exercises the
stencil tensor-functor data bridge and the Observation-4 interleaving
(auto-regressive error propagation).  It runs eagerly on the state's
device; a write into a clone stands for the reference's ``.at[].set``.

QoI: the state fields.  Metric: RMSE.  Surrogate: CNN grid -> grid,
served by the engine's ``Sequential`` (a conv net is not a pure MLP).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import approx_ml, tensor_functor
from repro_torch.device import resolve_device

NY, NX, NF = 32, 32, 4
DT = 0.02

# 5-point stencil over each of the 4 fields (paper Fig. 2's ifnctr,
# extended with a field axis): 20 features per grid point.
stencil_fn = tensor_functor(
    "mw_in: [i, j, 0:5, 0:4] = "
    "([i-1, j, 0:4], [i+1, j, 0:4], [i, j-1:j+2, 0:4])")
point_fn = tensor_functor("mw_out: [i, j, 0:4] = ([i, j, 0:4])")

RANGES = {"i": (1, NY - 1), "j": (1, NX - 1)}


def init_state(seed=0, device=None):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:NY, 0:NX] / NY
    rho = 1.0 + 0.1 * np.exp(-((x - 0.3) ** 2 + (y - 0.5) ** 2) * 40)
    u = 0.1 * np.ones_like(x)
    w = np.zeros_like(x)
    theta = 300.0 + 2.0 * np.exp(-((x - 0.6) ** 2 + (y - 0.4) ** 2) * 30) \
        + 0.01 * rng.normal(size=x.shape)
    s = np.stack([rho, u, w, (theta - 300.0)], -1).astype(np.float32)
    return torch.from_numpy(s).to(resolve_device(device))


def timestep(state):
    """One accurate finite-volume-style update (interior points)."""
    s = state
    sN = s[:-2, 1:-1]
    sS = s[2:, 1:-1]
    sW = s[1:-1, :-2]
    sE = s[1:-1, 2:]
    sC = s[1:-1, 1:-1]
    u, w, th = sC[..., 1], sC[..., 2], sC[..., 3]
    # upwind-ish advection + diffusion + buoyancy forcing
    ddx = (sE - sW) * 0.5
    ddy = (sS - sN) * 0.5
    lap = sN + sS + sW + sE - 4 * sC
    adv = -(u[..., None] * ddx + w[..., None] * ddy)
    new = sC + DT * (adv + 0.08 * lap)
    buoy = 0.05 * th  # potential-temp anomaly drives vertical momentum
    new[..., 2] = new[..., 2] + DT * buoy
    new[..., 3] = new[..., 3] + (-DT * 0.02 * w * th)
    out = state.clone()
    out[1:-1, 1:-1] = new
    return out


def accurate(state):
    return {"state": timestep(state)}


def make_region(mode="collect", model=None, database=None, serving=None,
                device=None):
    return approx_ml(accurate, name="miniweather",
                     inputs={"state": (stencil_fn, RANGES)},
                     outputs={"state": (point_fn, RANGES)},
                     mode=mode, model=model, database=database,
                     serving=serving, device=device)


def run(state, steps, region=None, interleave=(0, 1)):
    """Advance `steps`; interleave = (n_accurate, n_surrogate) per cycle."""
    na, ns = interleave
    cyc = max(1, na + ns)
    for t in range(steps):
        if region is None:
            state = timestep(state)
        else:
            state = region(predicate=(t % cyc) >= na, state=state)["state"]
    return state


def run_ensemble_async(states, steps, region, queue):
    """Advance an ensemble of trajectories through a serve queue.

    A single trajectory is auto-regressive (its surrogate calls cannot
    batch with each other), but an ensemble of E members can: every
    step enqueues E one-grid requests (``mode="infer_async"``) that the
    queue coalesces into one batch, so surrogate inference is E-way
    batched while each member still steps sequentially.
    """
    if region.mode != "infer_async" or region.serving is not queue:
        raise ValueError("run_ensemble_async needs an infer_async region "
                         "serving through this queue")
    states = list(states)
    for _ in range(steps):
        handles = [region(state=s) for s in states]
        queue.flush(region.model_path, reason="sweep_step")
        states = [h.result()["state"] for h in handles]
    return states


def qoi_error(ref, approx):
    return float(torch.sqrt(torch.mean((ref - approx) ** 2)))


def surrogate_space():
    return {"kind": "cnn", "grid": (NY - 2, NX - 2), "in_ch": 20,
            "out_ch": 4, "k1": (2, 8), "ch1": (4, 8), "k2": (0, 6)}
