"""Surrogate training on SurrogateDB data: Adam + early stopping
(counterpart of ``repro/nas/train_surrogate.py``).

Normalization stats ride along in the model bundle's ``extra`` field so
the inference engine reproduces them at deployment (the paper stores the
equivalent inside the TorchScript module).

What the reference fixes and this module keeps: the split and the
minibatch order come from one ``np.random.default_rng(seed)``; the
statistics are numpy's (std with ddof=0, where ``torch.std`` is
unbiased); the loss is ``mean((pred - y)^2)``; the optimizer is the
reference's own Adam, whose weight decay is decoupled and scaled by the
learning rate (``torch.optim.Adam(weight_decay=)`` adds it to the
gradient instead, and ``torch.optim.AdamW`` rounds differently).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.nn.layers import Sequential


@torch.no_grad()
def _adam(params, grads, state, lr, b1=0.9, b2=0.999, eps=1e-8, wd=0.0):
    """One Adam step on the lists ``params`` (updated in place) and
    ``grads``; ``state`` is ``(m, v, t)``.  Returns the new state.  The
    reference's arithmetic, op for op."""
    m, v, t = state
    t = t + 1
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    for p, g, mm, vv in zip(params, grads, m, v):
        mm.copy_(b1 * mm + (1 - b1) * g)
        vv.copy_(b2 * vv + (1 - b2) * g * g)
        p.copy_(p - lr * ((mm / c1) / (torch.sqrt(vv / c2) + eps) + wd * p))
    return m, v, t


def _snapshot(net: Sequential):
    return [{k: t.detach().clone() for k, t in layer.items()}
            for layer in net.param_list()]


def fit(net: Sequential, X, Y, *, lr=1e-3, weight_decay=0.0, dropout=0.0,
        batch_size=128, epochs=60, val_frac=0.2, seed=0, patience=8,
        x_reshape=None, device=None):
    """Train ``net`` on numpy (X, Y) on ``device`` (None means the CUDA
    card).  Returns ``(params, val_rmse, norm_stats)``: ``params`` the
    best epoch's per-layer parameter dicts, which ``net`` holds on
    return, in eval mode with gradients off as the engine expects.
    ``dropout`` is accepted for the reference's signature; the rate is
    the one of ``net``'s Dropout layers."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    perm = rng.permutation(n)
    cut = max(1, int(n * (1 - val_frac)))
    tr, va = perm[:cut], perm[cut:]
    x_mu, x_sd = X[tr].mean(0), X[tr].std(0) + 1e-6
    y_mu, y_sd = Y[tr].mean(0), Y[tr].std(0) + 1e-6
    Xn = (X - x_mu) / x_sd
    Yn = (Y - y_mu) / y_sd
    if x_reshape is not None:
        Xn = Xn.reshape((-1,) + tuple(x_reshape))

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    Xtr, Ytr = to_dev(Xn[tr]), to_dev(Yn[tr])
    Xva, Yva = to_dev(Xn[va]), to_dev(Yn[va])
    Yva = Yva.reshape((-1,) + tuple(net.out_shape()[1:]))

    net.init(seed)
    net.to(dev)
    params = [p for layer in net.param_list() for p in layer.values()]
    opt = ([torch.zeros_like(p) for p in params],
           [torch.zeros_like(p) for p in params], 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)

    best, best_params, bad = np.inf, _snapshot(net), 0
    bs = min(batch_size, len(tr))
    try:
        for p in params:
            p.requires_grad_(True)
        for _ in range(epochs):
            order = torch.from_numpy(rng.permutation(len(tr))).to(dev)
            net.train()
            for i in range(0, len(order) - bs + 1, bs):
                idx = order[i:i + bs]
                pred = net(Xtr[idx], generator=gen)
                loss = ((pred - Ytr[idx].reshape(pred.shape)) ** 2).mean()
                grads = torch.autograd.grad(loss, params)
                opt = _adam(params, grads, opt, lr, wd=weight_decay)
            net.eval()
            with torch.no_grad():
                vl = float(((net(Xva) - Yva) ** 2).mean())
            if vl < best - 1e-6:
                best, best_params, bad = vl, _snapshot(net), 0
            else:
                bad += 1
                if bad >= patience:
                    break
    finally:
        for p in params:
            p.requires_grad_(False)
        net.eval()
    net.load_params(best_params)
    # de-normalized validation RMSE
    val_rmse = float(np.sqrt(best) * np.mean(y_sd))
    stats = {"x_mu": x_mu.tolist(), "x_sd": x_sd.tolist(),
             "y_mu": y_mu.tolist(), "y_sd": y_sd.tolist()}
    return best_params, val_rmse, stats


@torch.no_grad()
def latency(net: Sequential, in_shape, reps=10, device=None):
    """Median wall time of a forward of ``net`` on zeros of ``in_shape``
    on ``device`` (the paper's latency objective): one warm-up call, each
    timed call ended by a synchronize on the card."""
    dev = resolve_device(device)
    x = torch.zeros(tuple(in_shape), device=dev)
    net.to(dev).eval()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    net(x)
    sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        net(x)
        sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))
