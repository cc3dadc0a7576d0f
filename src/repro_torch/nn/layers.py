"""Surrogate network layers as ``torch.nn.Module``s (counterpart of
``repro/nn/layers.py``).

Each layer keeps the JAX package's parameter names and layouts, so a
bundle written by either package loads in the other without a transpose:

* Dense ``w`` is ``[in, out]`` and the product is ``x @ w``;
* Conv2D works on NHWC activations with HWIO kernels at its interface
  and permutes to PyTorch's NCHW/OIHW only around ``F.conv2d``;
* ``Flatten`` flattens NHWC activations, in the JAX order;
* gelu is the tanh approximation (``jax.nn.gelu``'s default);
* LayerNorm uses eps 1e-6;
* ``SAME`` padding puts the odd extra row or column at the end, as XLA
  does, so it is padded explicitly (``padding="same"`` in PyTorch
  refuses stride > 1).

:class:`Sequential` builds its layers' parameters from the input shape
the way the JAX ``Sequential.init`` threads shapes.  ``forward`` is the
counterpart of the JAX ``Sequential.apply``: Dropout drops only in
training mode (``net.train()``) and only when the forward is given a
``torch.Generator``, the counterpart of ``apply(train=True, rng=key)``;
otherwise it is the identity.  Parameters are created with
``requires_grad=False``, which serving relies on;
:func:`repro_torch.nas.train_surrogate.fit` switches gradients on for the
net it trains and off again when it returns.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

ACTS = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
}


class Layer(nn.Module):
    """One layer: ``build`` creates its parameters for an input shape,
    ``init_params`` draws seeded initial values, ``spec`` is its JSON."""

    def build(self, in_shape) -> None:
        """Create zero parameters for ``in_shape`` (parameter-free layers
        create none)."""

    def init_params(self, rng: np.random.Generator, in_shape
                    ) -> Dict[str, np.ndarray]:
        return {}

    def out_shape(self, in_shape):
        return tuple(in_shape)

    def spec(self) -> dict:
        raise NotImplementedError

    def _param(self, name: str, shape) -> None:
        self.register_parameter(
            name, nn.Parameter(torch.zeros(tuple(shape)), requires_grad=False))

    def param_dict(self) -> Dict[str, torch.Tensor]:
        """This layer's parameters, keys sorted (the JAX pytree order)."""
        return {k: self._parameters[k] for k in sorted(self._parameters)}


def _he_normal(rng, shape, fan_in):
    return (rng.standard_normal(shape) * math.sqrt(2.0 / fan_in)
            ).astype(np.float32)


class Dense(Layer):
    def __init__(self, features: int, use_bias: bool = True):
        super().__init__()
        self.features = features
        self.use_bias = use_bias

    def build(self, in_shape):
        self._param("w", (in_shape[-1], self.features))
        if self.use_bias:
            self._param("b", (self.features,))

    def init_params(self, rng, in_shape):
        fan_in = in_shape[-1]
        p = {"w": _he_normal(rng, (fan_in, self.features), fan_in)}
        if self.use_bias:
            p["b"] = np.zeros((self.features,), np.float32)
        return p

    def forward(self, x):
        y = x @ self.w
        return y + self.b if self.use_bias else y

    def out_shape(self, in_shape):
        return tuple(in_shape[:-1]) + (self.features,)

    def spec(self):
        return {"kind": "dense", "features": self.features,
                "use_bias": self.use_bias}


def _same_pads(size: int, kernel: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2D(Layer):
    """NHWC conv with HWIO weights; SAME or VALID padding, optional stride."""

    def __init__(self, features, kernel, stride=1, padding="SAME",
                 use_bias=True):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {padding!r}")
        self.features, self.kernel = features, kernel
        self.stride, self.padding, self.use_bias = stride, padding, use_bias

    def build(self, in_shape):
        k = self.kernel
        self._param("w", (k, k, in_shape[-1], self.features))
        if self.use_bias:
            self._param("b", (self.features,))

    def init_params(self, rng, in_shape):
        k, cin = self.kernel, in_shape[-1]
        p = {"w": _he_normal(rng, (k, k, cin, self.features), cin * k * k)}
        if self.use_bias:
            p["b"] = np.zeros((self.features,), np.float32)
        return p

    def forward(self, x):
        xc = x.permute(0, 3, 1, 2)
        if self.padding == "SAME":
            top, bottom = _same_pads(xc.shape[2], self.kernel, self.stride)
            left, right = _same_pads(xc.shape[3], self.kernel, self.stride)
            xc = F.pad(xc, (left, right, top, bottom))
        y = F.conv2d(xc, self.w.permute(3, 2, 0, 1), stride=self.stride)
        y = y.permute(0, 2, 3, 1)
        return y + self.b if self.use_bias else y

    def out_shape(self, in_shape):
        n, h, w, _ = in_shape
        if self.padding == "SAME":
            oh, ow = -(-h // self.stride), -(-w // self.stride)
        else:
            oh = (h - self.kernel) // self.stride + 1
            ow = (w - self.kernel) // self.stride + 1
        return (n, oh, ow, self.features)

    def spec(self):
        return {"kind": "conv2d", "features": self.features,
                "kernel": self.kernel, "stride": self.stride,
                "padding": self.padding, "use_bias": self.use_bias}


class MaxPool2D(Layer):
    """VALID max pooling over NHWC activations."""

    def __init__(self, window, stride=None):
        super().__init__()
        self.window = window
        self.stride = stride or window

    def forward(self, x):
        y = F.max_pool2d(x.permute(0, 3, 1, 2), self.window, self.stride)
        return y.permute(0, 2, 3, 1)

    def out_shape(self, in_shape):
        n, h, w, c = in_shape
        oh = (h - self.window) // self.stride + 1
        ow = (w - self.window) // self.stride + 1
        return (n, oh, ow, c)

    def spec(self):
        return {"kind": "maxpool2d", "window": self.window,
                "stride": self.stride}


class Activation(Layer):
    def __init__(self, name: str):
        super().__init__()
        if name not in ACTS:
            raise ValueError(f"unknown activation {name!r}")
        self.name = name

    def forward(self, x):
        return ACTS[self.name](x)

    def spec(self):
        return {"kind": "act", "name": self.name}


class Dropout(Layer):
    """Train-time dropout: in training mode and given a generator, keeps
    each element with probability ``1 - rate`` and scales what it keeps
    by ``1 / (1 - rate)``; the identity otherwise."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.rate <= 0 or generator is None:
            return x
        keep = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=x.dtype) < 1 - self.rate
        return torch.where(keep, x / (1 - self.rate), 0.0)

    def spec(self):
        return {"kind": "dropout", "rate": self.rate}


class Flatten(Layer):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)

    def out_shape(self, in_shape):
        return (in_shape[0], int(np.prod(in_shape[1:], dtype=np.int64)))

    def spec(self):
        return {"kind": "flatten"}


class LayerNorm(Layer):
    def build(self, in_shape):
        self._param("scale", (in_shape[-1],))
        self._param("bias", (in_shape[-1],))

    def init_params(self, rng, in_shape):
        return {"scale": np.ones((in_shape[-1],), np.float32),
                "bias": np.zeros((in_shape[-1],), np.float32)}

    def forward(self, x):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-6) * self.scale + self.bias

    def spec(self):
        return {"kind": "layernorm"}


class Sequential(nn.Module):
    """Layers applied in order to inputs of shape ``in_shape`` (batch
    first; the batch entry of ``in_shape`` is a placeholder)."""

    def __init__(self, layers: Sequence[Layer], in_shape: Sequence[int]):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.in_shape = tuple(in_shape)
        shape = self.in_shape
        for layer in self.layers:
            layer.build(shape)
            shape = layer.out_shape(shape)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """``generator`` feeds the Dropout layers, in layer order, in
        training mode (the JAX ``apply``'s ``rng``)."""
        for layer in self.layers:
            x = layer(x, generator) if isinstance(layer, Dropout) \
                else layer(x)
        return x

    def init(self, seed: int = 0) -> "Sequential":
        """Fill the parameters with seeded He-normal weights and zero
        biases, drawn with numpy so any framework can repeat them."""
        rng = np.random.default_rng(seed)
        plist, shape = [], self.in_shape
        for layer in self.layers:
            plist.append(layer.init_params(rng, shape))
            shape = layer.out_shape(shape)
        return self.load_params(plist)

    def param_list(self) -> List[Dict[str, torch.Tensor]]:
        """One dict per layer, keys sorted: the JAX parameter pytree's
        structure, with this module's tensors as leaves."""
        return [layer.param_dict() for layer in self.layers]

    @torch.no_grad()
    def load_params(self, plist) -> "Sequential":
        """Copy a list of per-layer dicts (numpy arrays or tensors) into
        the parameters; names and shapes must match exactly."""
        plist = list(plist)
        if len(plist) != len(self.layers):
            raise ValueError(f"{len(plist)} parameter dicts for "
                             f"{len(self.layers)} layers")
        for i, (layer, p) in enumerate(zip(self.layers, plist)):
            mine = layer.param_dict()
            if sorted(p) != list(mine):
                raise ValueError(f"layer {i} ({layer.spec()['kind']}): "
                                 f"parameters {sorted(p)}, expected "
                                 f"{list(mine)}")
            for k, dst in mine.items():
                src = torch.as_tensor(p[k])
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"layer {i} {k}: shape "
                                     f"{tuple(src.shape)}, expected "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
        return self

    def out_shape(self):
        shape = self.in_shape
        for layer in self.layers:
            shape = layer.out_shape(shape)
        return shape

    def spec(self):
        return {"in_shape": list(self.in_shape),
                "layers": [layer.spec() for layer in self.layers]}

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


_KINDS = {
    "dense": lambda s: Dense(s["features"], s.get("use_bias", True)),
    "conv2d": lambda s: Conv2D(s["features"], s["kernel"], s["stride"],
                               s["padding"], s.get("use_bias", True)),
    "maxpool2d": lambda s: MaxPool2D(s["window"], s["stride"]),
    "act": lambda s: Activation(s["name"]),
    "dropout": lambda s: Dropout(s["rate"]),
    "flatten": lambda s: Flatten(),
    "layernorm": lambda s: LayerNorm(),
}


def from_spec(spec: dict) -> Sequential:
    layers = [_KINDS[layer["kind"]](layer) for layer in spec["layers"]]
    return Sequential(layers, tuple(spec["in_shape"]))


def MLP(in_shape, hidden: Sequence[int], out_features: int, act="relu",
        dropout: float = 0.0) -> Sequential:
    layers = []
    for h in hidden:
        layers += [Dense(h), Activation(act)]
        if dropout:
            layers.append(Dropout(dropout))
    layers.append(Dense(out_features))
    return Sequential(layers, in_shape)


def CNN(in_shape, convs, dense: Sequence[int], out_features: int,
        act="relu", pool: Optional[int] = None) -> Sequential:
    """convs: list of (features, kernel, stride)."""
    layers = []
    for f, k, s in convs:
        layers += [Conv2D(f, k, s), Activation(act)]
    if pool:
        layers.append(MaxPool2D(pool))
    layers.append(Flatten())
    for h in dense:
        layers += [Dense(h), Activation(act)]
    layers.append(Dense(out_features))
    return Sequential(layers, in_shape)
