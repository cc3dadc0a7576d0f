"""Binomial Options: CRR lattice pricing of American puts (counterpart of
``repro/apps/binomial.py``).

Accurate path: backward induction over a 256-step binomial tree per
option.  The reference's ``lax.scan`` over levels is a Python loop over
levels here, each level vectorized over all options.  QoI: option price.
Metric: RMSE.  Surrogate: small MLP on (S, K, T, r, sigma).

``price_chunks_async`` prices a sweep of option chunks through the serve
queue (the paper's many-callers regime).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import approx_ml, tensor_functor
from repro_torch.device import resolve_device

N_STEPS = 256

_ifn = tensor_functor("bin_in: [i, 0:5] = ([i, 0:5])")
_ofn = tensor_functor("bin_out: [i, 0:1] = ([i, 0:1])")


def make_inputs(n, seed=0, device=None):
    """[n, 5] = (S, K, T, r, sigma)."""
    rng = np.random.default_rng(seed)
    S = rng.uniform(5, 30, n)
    K = rng.uniform(1, 100, n)
    T = rng.uniform(0.25, 10, n)
    r = rng.uniform(0.01, 0.06, n)
    sig = rng.uniform(0.05, 0.5, n)
    return torch.from_numpy(np.stack([S, K, T, r, sig], 1)
                            .astype(np.float32)).to(resolve_device(device))


def prices(opts):
    """[n, 5] options -> [n] American put prices."""
    S, K, T, r, sig = (c[:, None] for c in opts.unbind(-1))
    dt = T / N_STEPS
    u = torch.exp(sig * torch.sqrt(dt))
    d = 1.0 / u
    p = (torch.exp(r * dt) - d) / (u - d)
    disc = torch.exp(-r * dt)
    j = torch.arange(N_STEPS + 1, device=opts.device)
    vals = torch.clamp(K - S * u ** (2 * j - N_STEPS).to(u.dtype), min=0.0)
    j = j[:-1]
    for level in range(N_STEPS - 1, -1, -1):
        cont = disc * (p * vals[:, 1:] + (1 - p) * vals[:, :-1])
        ex = torch.clamp(K - S * u ** (2 * j - level).to(u.dtype), min=0.0)
        vals = torch.cat([torch.maximum(cont, ex), torch.zeros_like(K)], 1)
    return vals[:, 0]


def accurate(opts):
    return {"out": prices(opts)[:, None]}


def make_region(n, mode="collect", model=None, database=None, serving=None,
                device=None):
    rngs = {"i": (0, n)}
    return approx_ml(accurate, name="binomial",
                     inputs={"opts": (_ifn, rngs)},
                     outputs={"out": (_ofn, rngs)},
                     mode=mode, model=model, database=database,
                     serving=serving, device=device)


def price_chunks_async(opts, region, queue, chunk: int):
    """Price a sweep of option chunks through the serve queue.

    Each chunk of ``chunk`` options is an independent region invocation
    (a separate solver instance or sweep step); all of a sweep's chunks
    are enqueued, then one flush coalesces them into a single batch.
    ``region`` must be ``make_region(chunk, mode="infer_async",
    serving=queue)``.
    """
    if region.mode != "infer_async" or region.serving is not queue:
        raise ValueError("price_chunks_async needs an infer_async region "
                         "serving through this queue")
    n = int(opts.shape[0])
    if n % chunk:
        raise ValueError(f"{n} options do not split into chunks of {chunk}")
    handles = [region(opts=opts[i:i + chunk]) for i in range(0, n, chunk)]
    queue.flush(region.model_path, reason="sweep_step")
    return torch.cat([h.result()["out"] for h in handles])


def qoi_error(ref, approx):
    ref = torch.as_tensor(ref).detach().cpu().numpy().reshape(-1)
    approx = torch.as_tensor(approx).detach().cpu().numpy().reshape(-1)
    return float(np.sqrt(np.mean((ref - approx) ** 2)))


def surrogate_space():
    return {"kind": "mlp", "in_dim": 5, "out_dim": 1,
            "hidden1": (32, 512, "log2"), "hidden2": (0, 512, "log2")}
