"""Gaussian process regression (numpy): Matérn-5/2 + Cholesky
(counterpart of ``repro/nas/gp.py``, the same arithmetic in the same
order, so both packages give the same bits).

The Ax/BoTorch role in the paper's workflow.  Inputs are normalized to
[0, 1]^d by the caller (see space.py).
"""
from __future__ import annotations

import numpy as np


def matern52(X1, X2, lengthscale, variance):
    d = np.sqrt(np.maximum(
        ((X1[:, None, :] - X2[None, :, :]) / lengthscale) ** 2, 0).sum(-1))
    s5 = np.sqrt(5.0) * d
    return variance * (1 + s5 + s5 ** 2 / 3.0) * np.exp(-s5)


class GP:
    def __init__(self, lengthscale=0.3, variance=1.0, noise=1e-4):
        self.ls, self.var, self.noise = lengthscale, variance, noise
        self.X = None

    def fit(self, X, y):
        X = np.asarray(X, float)
        y = np.asarray(y, float).reshape(-1)
        self.ymu, self.ystd = y.mean(), max(y.std(), 1e-9)
        yn = (y - self.ymu) / self.ystd
        # light lengthscale selection by marginal likelihood over a grid
        best = (None, -np.inf)
        for ls in (0.1, 0.2, 0.3, 0.5, 1.0):
            K = matern52(X, X, ls, self.var) + self.noise * np.eye(len(X))
            try:
                L = np.linalg.cholesky(K)
            except np.linalg.LinAlgError:
                continue
            a = np.linalg.solve(L.T, np.linalg.solve(L, yn))
            ll = -0.5 * yn @ a - np.log(np.diag(L)).sum()
            if ll > best[1]:
                best = (ls, ll)
        self.ls = best[0] or self.ls
        K = matern52(X, X, self.ls, self.var) + self.noise * np.eye(len(X))
        self.L = np.linalg.cholesky(K)
        self.alpha = np.linalg.solve(self.L.T, np.linalg.solve(self.L, yn))
        self.X = X
        return self

    def predict(self, Xs):
        Ks = matern52(np.asarray(Xs, float), self.X, self.ls, self.var)
        mu = Ks @ self.alpha
        v = np.linalg.solve(self.L, Ks.T)
        var = np.maximum(self.var - (v ** 2).sum(0), 1e-12)
        return mu * self.ystd + self.ymu, np.sqrt(var) * self.ystd
