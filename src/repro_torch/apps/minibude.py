"""MiniBUDE (virtual screening): pose -> ligand-protein binding energy
(counterpart of ``repro/apps/minibude.py``).

The accurate path evaluates an empirical forcefield over all ligand x
protein atom pairs for every pose.  The JAX ``vmap`` over poses is
written out here as a leading batch dimension.  Molecules and poses are
drawn from the same numpy seeds as the JAX app, so both packages see the
same numbers.  QoI: per-pose energy.  Metric: MAPE.

Surrogate: MLP pose[6] -> energy (paper Table IV space: 2-12 hidden
layers, width 64..4096 with a feature multiplier).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import approx_ml, tensor_functor
from repro_torch.device import resolve_device

N_LIG, N_PROT = 16, 64

_ifn = tensor_functor("bude_in: [i, 0:6] = ([i, 0:6])")
_ofn = tensor_functor("bude_out: [i, 0:1] = ([i, 0:1])")


def make_molecule(seed=0, device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    draws = dict(
        lig=rng.normal(0, 1.0, (N_LIG, 3)),
        prot=rng.normal(0, 4.0, (N_PROT, 3)),
        lq=rng.uniform(-1, 1, (N_LIG,)),
        pq=rng.uniform(-1, 1, (N_PROT,)),
        lr=rng.uniform(1.0, 2.0, (N_LIG,)),
        pr=rng.uniform(1.0, 2.0, (N_PROT,)))
    return {k: torch.from_numpy(v.astype(np.float32)).to(dev)
            for k, v in draws.items()}


@functools.lru_cache(maxsize=None)
def _molecule(device: str):
    return make_molecule(0, device)


def make_inputs(n, seed=0, device=None):
    """Poses: [n, 6] = (rx, ry, rz, tx, ty, tz)."""
    rng = np.random.default_rng(seed)
    rot = rng.uniform(-np.pi, np.pi, (n, 3))
    trans = rng.uniform(-2, 2, (n, 3))
    return torch.from_numpy(np.concatenate([rot, trans], 1)
                            .astype(np.float32)).to(resolve_device(device))


def _rot_matrices(r):
    """[n, 3] angles -> [n, 3, 3] rotations Rz @ Ry @ Rx."""
    cx, cy, cz = torch.cos(r).unbind(-1)
    sx, sy, sz = torch.sin(r).unbind(-1)
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)

    def mat(*rows):
        return torch.stack([torch.stack(row, -1) for row in rows], -2)

    Rx = mat((one, zero, zero), (zero, cx, -sx), (zero, sx, cx))
    Ry = mat((cy, zero, sy), (zero, one, zero), (-sy, zero, cy))
    Rz = mat((cz, -sz, zero), (sz, cz, zero), (zero, zero, one))
    return Rz @ Ry @ Rx


def energies(poses, mol=None):
    """Accurate path: [n, 6] poses -> [n] binding energies."""
    mol = _molecule(str(poses.device)) if mol is None else mol
    R = _rot_matrices(poses[:, :3])
    lig = mol["lig"] @ R.transpose(1, 2) + poses[:, None, 3:]
    # soft-core distances (standard forcefield softening): bounds the
    # r^-12 steric wall so energies stay in a learnable range
    d2 = ((lig[:, :, None, :] - mol["prot"][None, None]) ** 2).sum(-1)
    d = torch.sqrt(d2 + 0.5)
    elec = mol["lq"][:, None] * mol["pq"][None] / d
    sigma = (mol["lr"][:, None] + mol["pr"][None]) * 0.5
    s = torch.clamp(sigma / d, max=1.4)
    s2 = s * s
    sr6 = s2 * (s2 * s2)  # x**6 multiplied out as lax.integer_pow does
    steric = sr6 * sr6 - sr6
    return (elec + 0.1 * steric).sum((1, 2))


def accurate(poses):
    return {"out": energies(poses)[:, None]}


def make_region(n, mode="collect", model=None, database=None, serving=None,
                device=None):
    """``serving=`` attaches a serve queue, as binomial's and
    miniweather's regions take one (the reference's minibude region has
    no such argument)."""
    rngs = {"i": (0, n)}
    return approx_ml(accurate, name="minibude",
                     inputs={"poses": (_ifn, rngs)},
                     outputs={"out": (_ofn, rngs)},
                     mode=mode, model=model, database=database,
                     serving=serving, device=device)


def qoi_error(ref, approx):
    """MAPE over pose energies."""
    ref = torch.as_tensor(ref).detach().cpu().numpy().reshape(-1)
    approx = torch.as_tensor(approx).detach().cpu().numpy().reshape(-1)
    return float(np.mean(np.abs((approx - ref) / (np.abs(ref) + 1e-6)))) * 100


def surrogate_space():
    return {
        "kind": "mlp", "in_dim": 6, "out_dim": 1,
        "n_hidden": (2, 6), "hidden1": (64, 1024, "log2"),
        "feature_mult": (0.1, 0.8),
    }
