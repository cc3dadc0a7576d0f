"""Bonds: fixed-rate bond valuation with a flat forward curve
(counterpart of ``repro/apps/bonds.py``).

Accurate path: every coupon period of every bond (a masked sum), giving
dirty price and accrued interest.  The JAX ``vmap`` over bonds is written
out as a leading batch dimension.  QoI: accrued interest.  Metric: RMSE.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import approx_ml, tensor_functor
from repro_torch.device import resolve_device

MAX_PERIODS = 60  # semiannual coupons, up to 30y

_ifn = tensor_functor("bond_in: [i, 0:4] = ([i, 0:4])")
_ofn = tensor_functor("bond_out: [i, 0:2] = ([i, 0:2])")


def make_inputs(n, seed=0, device=None):
    """[n, 4] = (coupon_rate, ytm, years_to_maturity, accrual_frac)."""
    rng = np.random.default_rng(seed)
    coupon = rng.uniform(0.01, 0.09, n)
    ytm = rng.uniform(0.005, 0.10, n)
    years = rng.uniform(0.5, 30.0, n)
    accr = rng.uniform(0.0, 1.0, n)
    return torch.from_numpy(np.stack([coupon, ytm, years, accr], 1)
                            .astype(np.float32)).to(resolve_device(device))


def valuations(bonds, face=100.0, freq=2.0):
    """[n, 4] -> [n, 2] = (accrued interest, dirty price)."""
    coupon, ytm, years, accr = (c[:, None] for c in bonds.unbind(-1))
    nper = torch.floor(years * freq)
    cpn = face * coupon / freq
    per = torch.arange(1, MAX_PERIODS + 1, dtype=torch.float32,
                       device=bonds.device)
    t = (per - accr) / freq
    mask = per <= nper
    df = torch.exp(-ytm * t)  # flat forward curve, continuous compounding
    pv_coupons = torch.where(mask, cpn * df, 0.0).sum(1, keepdim=True)
    t_face = (nper - accr) / freq
    pv_face = face * torch.exp(-ytm * t_face)
    dirty = pv_coupons + pv_face
    accrued = cpn * accr
    return torch.cat([accrued, dirty], 1)


def accurate(bonds):
    return {"out": valuations(bonds)}


def make_region(n, mode="collect", model=None, database=None, device=None):
    rngs = {"i": (0, n)}
    return approx_ml(accurate, name="bonds",
                     inputs={"bonds": (_ifn, rngs)},
                     outputs={"out": (_ofn, rngs)},
                     mode=mode, model=model, database=database,
                     device=device)


def qoi_error(ref, approx):
    """RMSE over accrued interest (the paper's QoI)."""
    ref = torch.as_tensor(ref).detach().cpu().numpy()[:, 0]
    approx = torch.as_tensor(approx).detach().cpu().numpy()[:, 0]
    return float(np.sqrt(np.mean((ref - approx) ** 2)))


def surrogate_space():
    return {"kind": "mlp", "in_dim": 4, "out_dim": 2,
            "hidden1": (32, 512, "log2"), "hidden2": (0, 512, "log2")}
