"""Nested two-level Bayesian optimization (paper §V-C; counterpart of
``repro/nas/nested.py``).

Outer level: multi-objective (inference latency, validation error) over
the architecture space — ParEGO-style random Chebyshev scalarization with
a GP + expected improvement, early-stopped after ``stall`` non-improving
trials (paper: 5).  Architectures on the Pareto front are then tuned in
the inner level over the Table-V hyper-parameter space.  Training and
the latency objective run on ``device`` (None means the CUDA card).
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.engine import InferenceEngine
from repro_torch.nas.gp import GP
from repro_torch.nas.space import Space, arch_space, build_net, hyper_space
from repro_torch.nas.train_surrogate import fit, latency
from repro_torch.nn.serialize import save_model


def expected_improvement(mu, sd, best):
    z = (best - mu) / np.maximum(sd, 1e-9)
    Phi = 0.5 * (1 + np.vectorize(math.erf)(z / math.sqrt(2)))
    phi = np.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)
    return (best - mu) * Phi + sd * phi


def bo_minimize(objective, space: Space, *, iters=20, init=5, seed=0,
                stall=5):
    """Single-objective BO. Returns (best_cfg, best_val, history)."""
    rng = np.random.default_rng(seed)
    U = space.sample(rng, init)
    ys, hist = [], []
    for u in U:
        cfg = space.decode(u)
        y = objective(cfg)
        ys.append(y)
        hist.append((cfg, y))
    U = list(U)
    bad = 0
    for _ in range(iters - init):
        gp = GP().fit(np.asarray(U), np.asarray(ys))
        cand = space.sample(rng, 256)
        mu, sd = gp.predict(cand)
        ei = expected_improvement(mu, sd, min(ys))
        u = cand[int(np.argmax(ei))]
        cfg = space.decode(u)
        y = objective(cfg)
        improved = y < min(ys) - 1e-12
        U.append(u)
        ys.append(y)
        hist.append((cfg, y))
        bad = 0 if improved else bad + 1
        if bad >= stall:
            break
    i = int(np.argmin(ys))
    return hist[i][0], ys[i], hist


def pareto_front(points):
    """Indices of non-dominated (minimize both) points."""
    pts = np.asarray(points, float)
    keep = []
    for i, p in enumerate(pts):
        dominated = ((pts <= p).all(1) & (pts < p).any(1)).any()
        if not dominated:
            keep.append(i)
    return keep


def nested_search(app, db_group, *, outer_iters=12, inner_iters=6, seed=0,
                  epochs=25, stall=5, verbose=True, device=None):
    """Paper §V-C: outer NAS (latency+error Pareto) -> inner HPO.

    Returns dict with trials (arch cfg, latency, val_rmse, params, net) and
    the Pareto-front indices.
    """
    space_cfg = app.surrogate_space()
    aspace = arch_space(space_cfg)
    data = db_group.load()
    X = data["inputs"].reshape(data["inputs"].shape[0], -1)
    Y = data["outputs"].reshape(data["outputs"].shape[0], -1)
    x_reshape = None
    if space_cfg["kind"] == "cnn":
        gh, gw = space_cfg["grid"]
        x_reshape = (gh, gw, space_cfg["in_ch"])

    rng = np.random.default_rng(seed)
    trials = []

    def eval_arch(cfg):
        net = build_net(space_cfg, cfg)
        params, val_rmse, stats = fit(net, X, Y, epochs=epochs,
                                      seed=seed, x_reshape=x_reshape,
                                      device=device)
        in_shape = (256,) + tuple(net.in_shape[1:])
        lat = latency(net, in_shape, device=device)
        trials.append({"arch": cfg, "latency": lat, "val_rmse": val_rmse,
                       "net": net, "params": params, "stats": stats})
        if verbose:
            print(f"  [outer] {cfg} -> rmse={val_rmse:.4g} lat={lat*1e3:.2f}ms",
                  flush=True)
        return val_rmse, lat

    # ---- outer: ParEGO scalarization ----
    U = aspace.sample(rng, min(4, outer_iters))
    for u in U:
        eval_arch(aspace.decode(u))
    U = list(U)
    bad = 0
    while len(trials) < outer_iters and bad < stall:
        errs = np.asarray([t["val_rmse"] for t in trials])
        lats = np.asarray([t["latency"] for t in trials])
        ne = (errs - errs.min()) / max(np.ptp(errs), 1e-12)
        nl = (lats - lats.min()) / max(np.ptp(lats), 1e-12)
        w = rng.uniform(0.1, 0.9)
        scal = np.maximum(w * ne, (1 - w) * nl) + 0.05 * (w * ne + (1 - w) * nl)
        gp = GP().fit(np.asarray(U), scal)
        cand = aspace.sample(rng, 256)
        mu, sd = gp.predict(cand)
        ei = expected_improvement(mu, sd, scal.min())
        u = cand[int(np.argmax(ei))]
        n_before = len(pareto_front(np.stack([errs, lats], 1)))
        eval_arch(aspace.decode(u))
        U.append(u)
        errs2 = np.asarray([t["val_rmse"] for t in trials])
        lats2 = np.asarray([t["latency"] for t in trials])
        improved = len(pareto_front(np.stack([errs2, lats2], 1))) > n_before \
            or errs2[-1] <= errs.min() or lats2[-1] <= lats.min()
        bad = 0 if improved else bad + 1

    # ---- inner: hyper-parameter tuning of Pareto archs ----
    errs = np.asarray([t["val_rmse"] for t in trials])
    lats = np.asarray([t["latency"] for t in trials])
    front = pareto_front(np.stack([errs, lats], 1))
    hspace = hyper_space()
    for fi in front:
        t = trials[fi]

        def obj(h):
            net = build_net(space_cfg, t["arch"], dropout=h["dropout"])
            params, rmse, stats = fit(
                net, X, Y, lr=h["lr"], weight_decay=h["weight_decay"],
                batch_size=h["batch_size"], epochs=epochs, seed=seed,
                x_reshape=x_reshape, device=device)
            if rmse < t["val_rmse"]:
                t.update(params=params, val_rmse=rmse, stats=stats, net=net,
                         hypers=h)
            return rmse

        if inner_iters > 0:
            bo_minimize(obj, hspace, iters=inner_iters,
                        init=min(3, inner_iters), seed=seed + fi, stall=3)
    errs = np.asarray([t["val_rmse"] for t in trials])
    lats = np.asarray([t["latency"] for t in trials])
    return {"trials": trials,
            "pareto": pareto_front(np.stack([errs, lats], 1))}


def save_trial(trial, path):
    """Persist a searched surrogate as a loadable model bundle.

    Invalidates any engine already serving this path, so regions pick up
    the retrained weights instead of the process-wide cached ones.  The
    trial's net holds its trained parameters (``fit`` leaves them in it).
    """
    out = save_model(path, trial["net"], extra=trial["stats"])
    InferenceEngine.invalidate(out)
    return out


def best_trial(result):
    """Lowest-validation-error Pareto member (paper's deployment pick)."""
    front = result["pareto"]
    return min((result["trials"][i] for i in front),
               key=lambda t: t["val_rmse"])
