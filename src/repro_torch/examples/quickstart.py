"""Quickstart: the HPAC-ML programming model on the port (twin of
``examples/quickstart.py``).

Mirrors the paper's Fig. 2: a 2-D stencil region annotated with tensor
functors, run in collect mode, then replaced by a surrogate.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
import pathlib
import tempfile

import numpy as np
import torch

from repro_torch.core import approx_ml, tensor_functor
from repro_torch.device import resolve_device
from repro_torch.nas.train_surrogate import fit
from repro_torch.nn import MLP
from repro_torch.nn.serialize import save_model

N = M = 34

# --- declare the data bridge (paper Fig. 2 syntax) -------------------------
ifn = tensor_functor("ifnctr: [i, j, 0:5] = ([i-1,j],[i+1,j],[i,j-1:j+2])")
ofn = tensor_functor("ofnctr: [i, j] = ([i,j])")
RANGES = {"i": (1, N - 1), "j": (1, M - 1)}


# --- the accurate execution path -------------------------------------------
def smooth_step(t):
    """5-point smoothing: the computation the surrogate will replace."""
    interior = 0.2 * (t[1:-1, 1:-1] + t[:-2, 1:-1] + t[2:, 1:-1]
                      + t[1:-1, :-2] + t[1:-1, 2:])
    out = t.clone()
    out[1:-1, 1:-1] = interior
    return {"t": out}


def quickstart(t, workdir, *, steps=64, epochs=40, device=None):
    """collect -> fit -> save -> predicated infer from the grid ``t``.
    Returns the number of samples, the surrogate's validation RMSE, its
    RMSE against one accurate step of ``t`` and whether the accurate path
    of the predicated region is exact."""
    dev = resolve_device(device)
    workdir = pathlib.Path(workdir)
    t = t.to(dev)

    # 1) collect training data while running the real code
    region = approx_ml(smooth_step, name="smooth",
                       inputs={"t": (ifn, RANGES)},
                       outputs={"t": (ofn, RANGES)},
                       mode="collect", database=str(workdir / "db"),
                       device=dev)
    state = t
    for _ in range(steps):
        state = region(t=state)["t"]
    region.db.flush()

    # 2) train a surrogate offline from the database
    d = region.db.group("smooth").load()
    X = d["inputs"].reshape(-1, 5)
    Y = d["outputs"].reshape(-1, 1)
    net = MLP((1, 5), [32], 1)
    _, rmse, stats = fit(net, X, Y, epochs=epochs, device=dev)
    mp = save_model(workdir / "model", net, extra=stats)

    # 3) same region, now predicated: accurate and surrogate paths coexist
    region2 = approx_ml(smooth_step, name="smooth",
                        inputs={"t": (ifn, RANGES)},
                        outputs={"t": (ofn, RANGES)},
                        mode="predicated", model=str(mp), device=dev)
    ref = smooth_step(t)["t"]
    ml = region2(predicate=True, t=t)["t"]
    acc = region2(predicate=False, t=t)["t"]
    return {"samples": int(X.shape[0]), "val_rmse": rmse,
            "surrogate_rmse": float(torch.sqrt(torch.mean((ml - ref) ** 2))),
            "accurate_exact": bool(torch.equal(acc, ref))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    t = torch.from_numpy(np.random.default_rng(0).standard_normal((N, M))
                         .astype(np.float32))
    res = quickstart(t, tempfile.mkdtemp(), device=args.device)
    print(f"collected {res['samples']} samples; surrogate val "
          f"RMSE={res['val_rmse']:.5f}")
    print("surrogate RMSE vs accurate:", res["surrogate_rmse"])
    print("accurate path exact:", res["accurate_exact"])


if __name__ == "__main__":
    main()
