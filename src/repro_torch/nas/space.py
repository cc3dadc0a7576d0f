"""Search-space parameterization: named dims -> unit cube <-> configs
(counterpart of ``repro/nas/space.py``)."""
from __future__ import annotations

import math

from repro_torch.nn.layers import (CNN, MLP, Activation, Conv2D,
                                   Sequential)


class Dim:
    def __init__(self, name, lo, hi, kind="float"):
        self.name, self.lo, self.hi, self.kind = name, lo, hi, kind

    def decode(self, u):
        if self.kind == "float":
            return self.lo + u * (self.hi - self.lo)
        if self.kind == "int":
            return int(round(self.lo + u * (self.hi - self.lo)))
        if self.kind == "log2":
            lo = math.log2(max(self.lo, 1))
            hi = math.log2(self.hi)
            return int(2 ** round(lo + u * (hi - lo)))
        raise ValueError(self.kind)


class Space:
    def __init__(self, dims):
        self.dims = dims

    @property
    def d(self):
        return len(self.dims)

    def sample(self, rng, n):
        return rng.uniform(0, 1, (n, self.d))

    def decode(self, u):
        return {dim.name: dim.decode(float(x))
                for dim, x in zip(self.dims, u)}


# Paper Table V: the (inner) training hyper-parameter space
def hyper_space():
    return Space([
        Dim("lr", 1e-4, 1e-2, "float"),
        Dim("weight_decay", 1e-4, 1e-1, "float"),
        Dim("dropout", 0.0, 0.8, "float"),
        Dim("batch_size", 32, 512, "log2"),
    ])


def arch_space(app_space: dict) -> Space:
    """Paper Table IV, per benchmark kind."""
    dims = []
    if app_space["kind"] == "mlp":
        if "n_hidden" in app_space:
            dims.append(Dim("n_hidden", *app_space["n_hidden"], "int"))
            dims.append(Dim("hidden1", app_space["hidden1"][0],
                            app_space["hidden1"][1], "log2"))
            dims.append(Dim("feature_mult", *app_space["feature_mult"],
                            "float"))
        else:
            dims.append(Dim("hidden1", app_space["hidden1"][0],
                            app_space["hidden1"][1], "log2"))
            dims.append(Dim("hidden2", 1, app_space["hidden2"][1], "log2"))
    else:  # cnn
        for key, rng in app_space.items():
            if key in ("kind", "grid", "in_ch", "out_ch"):
                continue
            lo, hi = rng
            dims.append(Dim(key, lo, hi, "int"))
    return Space(dims)


def build_net(app_space: dict, arch_cfg: dict, dropout=0.0) -> Sequential:
    """Instantiate the Sequential for one sampled architecture."""
    if app_space["kind"] == "mlp":
        if "n_hidden" in app_space:
            widths = []
            w = arch_cfg["hidden1"]
            for _ in range(arch_cfg["n_hidden"]):
                widths.append(max(4, int(w)))
                w = w * arch_cfg["feature_mult"]
            hidden = widths
        else:
            hidden = [arch_cfg["hidden1"]]
            if arch_cfg.get("hidden2", 0) > 1:
                hidden.append(arch_cfg["hidden2"])
        return MLP((1, app_space["in_dim"]), hidden, app_space["out_dim"],
                   dropout=dropout)
    gh, gw = app_space["grid"]
    convs = []
    if "conv_k" in arch_cfg:  # particlefilter-style
        k = max(2, arch_cfg["conv_k"])
        s = max(1, arch_cfg.get("stride", 1))
        convs.append((8, k, s))
    else:  # miniweather-style
        convs.append((arch_cfg.get("ch1", 8), max(2, arch_cfg.get("k1", 3)),
                      1))
        if arch_cfg.get("k2", 0) >= 2:
            convs.append((app_space["out_ch"] * 4, arch_cfg["k2"], 1))
    dense = []
    if arch_cfg.get("fc2", 0) > 8:
        dense.append(arch_cfg["fc2"])
    out_dim = app_space["out_ch"]
    if app_space.get("dense_out", True) and app_space["out_ch"] <= 4 and \
            "conv_k" in arch_cfg:
        # regression head (particlefilter): flatten -> fc -> (x, y)
        pool = max(1, arch_cfg.get("pool", 1))
        return CNN((1, gh, gw, app_space["in_ch"]), convs, dense, out_dim,
                   pool=pool if pool > 1 else None)
    # dense prediction (miniweather): conv stack, same-size output
    layers = []
    for f, k, _ in convs:
        layers += [Conv2D(f, k, 1, "SAME"), Activation("relu")]
    layers.append(Conv2D(app_space["out_ch"], 3, 1, "SAME"))
    return Sequential(layers, (1, gh, gw, app_space["in_ch"]))
