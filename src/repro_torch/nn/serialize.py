"""Model bundles: ``spec.json`` + ``params.npz`` (counterpart of
``repro/nn/serialize.py``), in the same format so either package reads
the other's bundles.

``params.npz`` holds leaves ``p0, p1, ...`` in JAX pytree-flatten order
of the per-layer parameter list: layers in order, each layer's dict keys
sorted, so Dense stores ``b`` before ``w`` and LayerNorm ``bias`` before
``scale``; parameter-free layers contribute nothing.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.nn.layers import Sequential, from_spec


def _flatten(plist):
    return [p[k] for p in plist for k in sorted(p)]


def save_model(path, net: Sequential, extra: dict | None = None) -> str:
    """Write ``net``'s spec and parameters as a bundle at ``path``."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    spec = net.spec()
    if extra:
        spec["extra"] = extra
    (path / "spec.json").write_text(json.dumps(spec, indent=1))
    flat = _flatten(net.param_list())
    np.savez(path / "params.npz",
             **{f"p{i}": t.detach().cpu().numpy() for i, t in enumerate(flat)})
    return str(path)


def _unflatten(net: Sequential, flat):
    """Cut the flat leaves back into the per-layer dicts of ``net``."""
    template = net.param_list()
    n = sum(len(p) for p in template)
    if len(flat) != n:
        raise ValueError(f"bundle holds {len(flat)} arrays, the spec "
                         f"needs {n}")
    it = iter(flat)
    return [{k: next(it) for k in p} for p in template]


def load_model(path, device=None):
    """Returns ``(net, params, spec)``: ``net`` on ``device`` (None means
    CUDA), ``params`` its per-layer parameter dicts."""
    dev = resolve_device(device)
    path = pathlib.Path(path)
    spec = json.loads((path / "spec.json").read_text())
    net = from_spec(spec)
    with np.load(path / "params.npz") as z:
        flat = [z[f"p{i}"] for i in range(len(z.files))]
    net.load_params(_unflatten(net, flat))
    net = net.to(dev).eval()
    return net, net.param_list(), spec


def params_from_jax(spec: dict, params) -> list:
    """The port's per-layer parameters from a JAX parameter pytree given
    as numpy arrays (a list of dicts, one per layer of ``spec``).

    Layouts are shared (Dense ``[in, out]``, Conv HWIO), so each leaf is
    checked against the layer the spec builds and converted to an f32
    tensor; the result loads with :meth:`Sequential.load_params`.
    """
    net = from_spec(spec)
    template = net.param_list()
    params = list(params)
    if len(params) != len(template):
        raise ValueError(f"{len(params)} parameter dicts for "
                         f"{len(template)} layers")
    out = []
    for i, (p, want) in enumerate(zip(params, template)):
        if sorted(p) != list(want):
            raise ValueError(f"layer {i}: parameters {sorted(p)}, expected "
                             f"{list(want)}")
        layer = {}
        for k, t in want.items():
            a = np.asarray(p[k], np.float32)
            if a.shape != tuple(t.shape):
                raise ValueError(f"layer {i} {k}: shape {a.shape}, expected "
                                 f"{tuple(t.shape)}")
            layer[k] = torch.from_numpy(a.copy())
        out.append(layer)
    return out


def qlayers_from_jax(qlayers, acts, device=None):
    """The port's packed int8 stack from the JAX ``quantize_params``
    output given as numpy arrays (``[(wq int8 [in, out], ws f32 [out],
    b f32 [out]), ...]``), on ``device`` (None means CUDA): a
    :class:`repro_torch.kernels.fused_mlp.int8.PackedInt8MLP`.  The
    values are taken as they are, so both packages run the same
    quantized layers."""
    from repro_torch.kernels.fused_mlp.int8 import pack_int8_mlp
    dev = resolve_device(device)
    layers = []
    for i, (wq, ws, b) in enumerate(qlayers):
        wq = np.asarray(wq)
        if wq.dtype != np.int8:
            raise ValueError(f"layer {i}: wq is {wq.dtype}, expected int8")
        layers.append(tuple(torch.from_numpy(np.array(a)).to(dev) for a in
                            (wq, np.asarray(ws, np.float32),
                             np.asarray(b, np.float32))))
    return pack_int8_mlp(layers, acts)
