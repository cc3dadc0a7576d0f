"""Execution control: the ``approx ml`` region (counterpart of
``repro/core/region.py``; paper §III, §IV-B).

``MLRegion`` wraps the *accurate execution path*, a function of torch
tensors, and per ml-mode:

* ``collect``    -- run the accurate path, bridge its inputs/outputs to
  tensor space, and append (inputs, outputs, runtime) to the
  SurrogateDB group of this region;
* ``infer``      -- replace the region with surrogate inference through
  the data bridge;
* ``predicated`` -- a boolean picks the path per invocation (eagerly:
  inference when true, the accurate path, collecting when the region
  has a database, when false).

The accurate path's wall time is taken on the host around work that ends
in ``torch.cuda.synchronize()`` when the region runs on CUDA.

Still to be ported, with their parts of the runtime: ``infer_async`` and
the ``serving=`` hook (``serve/``), circuit breakers and the accurate
fallback (``resilience/``), shadow scoring (``obs/``), and the traced
``lax.cond``/``io_callback`` path, which has no eager torch counterpart.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.database import SurrogateDB
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.functor import TensorFunctor
from repro_torch.core.tensor_map import TensorMap
from repro_torch.device import resolve_device


class MLRegion:
    def __init__(self, name: str, fn: Callable, *,
                 inputs: Dict[str, Tuple[TensorFunctor, dict]],
                 outputs: Dict[str, Tuple[TensorFunctor, dict]],
                 mode: str = "predicated",
                 model: Optional[str] = None,
                 database=None,
                 device=None):
        if mode not in ("collect", "infer", "predicated"):
            raise ValueError(f"region {name}: unknown mode {mode!r}")
        self.name, self.fn, self.mode = name, fn, mode
        self.inputs, self.outputs = inputs, outputs
        self.model_path = model
        self.device = resolve_device(device)
        self.db = (database if isinstance(database, SurrogateDB)
                   else SurrogateDB(database)) if database else None

    # ------------------------------------------------------ data bridge ---
    def bridge_in(self, arrays: dict):
        """App memory -> model input tensor [sweep..., features]."""
        parts = [TensorMap(functor, arrays[name], ranges, "to").to_tensor()
                 for name, (functor, ranges) in self.inputs.items()]
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.reshape(p.shape[:1] + (-1,)) if p.ndim > 1
                          else p[:, None] for p in parts], dim=-1)

    def bridge_out_tensors(self, out_arrays: dict):
        parts = [TensorMap(functor, out_arrays[name], ranges, "to")
                 .to_tensor()
                 for name, (functor, ranges) in self.outputs.items()]
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.reshape(p.shape[:1] + (-1,)) for p in parts],
                         dim=-1)

    def bridge_from(self, tensor, arrays: dict):
        """Model output tensor -> app memory (through the out functors).

        Pure outputs (not also region inputs) get a zero template covering
        exactly the functor's written window.
        """
        out = {}
        offset = 0
        for name, (functor, ranges) in self.outputs.items():
            if name in arrays:
                template = arrays[name]
            else:
                probe = TensorMap(functor, None, ranges, "from")
                template = torch.zeros(probe.min_array_shape(),
                                       dtype=tensor.dtype,
                                       device=tensor.device)
            tm = TensorMap(functor, template, ranges, "from")
            want = tm.tensor_shape
            n = int(np.prod(want[len(want) - _feat_dims(tm):])) if want else 1
            if len(self.outputs) == 1:
                piece = tensor.reshape(want)
            else:
                flatfeat = tensor.reshape(tensor.shape[0], -1)
                piece = flatfeat[:, offset:offset + n].reshape(want)
                offset += n
            out[name] = tm.from_tensor(piece)
        return out

    # ------------------------------------------------------- execution ----
    def engine(self) -> InferenceEngine:
        if not self.model_path:
            raise ValueError(f"region {self.name}: no model path")
        # through the process-wide cache: a dict lookup plus a stat, and
        # what reloads a bundle retrained under this region's feet
        return InferenceEngine.get(self.model_path, self.device)

    def _rows_in(self, arrays: dict):
        """Bridge app arrays to engine-shaped f32 rows [n, *in_shape[1:]]."""
        X = self.bridge_in(arrays)
        eng = self.engine()
        in_shape = tuple(eng.spec["in_shape"])
        return eng, X.reshape((-1,) + in_shape[1:]).to(torch.float32)

    def _infer(self, arrays: dict):
        eng, Xb = self._rows_in(arrays)
        return self.bridge_from(eng(Xb), arrays)

    def _n_sweep(self) -> int:
        functor = next(iter(self.inputs.values()))[0]
        return len(functor.sweep_symbols)

    def _rows(self, X):
        """DB row layout (paper §V-B): outer dim = unique data identifier.

        One sweep dim (e.g. pose/option index): each sweep entry is a row.
        Spatial sweeps (stencils): the whole tensor is one row.
        """
        X = X.detach().cpu().numpy()
        if self._n_sweep() <= 1:
            return X.reshape(X.shape[0], -1) if X.ndim > 1 else X[:, None]
        return X[None]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _accurate(self, arrays: dict, collect: bool):
        if not collect:
            return self.fn(**arrays)
        X = self._rows(self.bridge_in(arrays))
        self._sync()
        t0 = time.perf_counter()
        outs = self.fn(**arrays)
        self._sync()
        dt = time.perf_counter() - t0
        Y = self._rows(self.bridge_out_tensors(outs))
        self.db.group(self.name).append(X, Y, dt)
        return outs

    def __call__(self, predicate=None, **arrays):
        if self.mode == "collect":
            return self._accurate(arrays, collect=True)
        if self.mode == "infer":
            return self._infer(arrays)
        if predicate is None:
            raise ValueError(f"region {self.name}: a predicated region "
                             f"needs a predicate")
        if bool(predicate):
            return self._infer(arrays)
        return self._accurate(arrays, collect=self.db is not None)


def _feat_dims(tm: TensorMap) -> int:
    _, feat = tm._lhs_dims()
    return len(feat)


def approx_ml(fn=None, **kw) -> MLRegion:
    """Factory mirroring the ``#pragma approx ml(...)`` clause."""
    name = kw.pop("name", getattr(fn, "__name__", "region"))
    return MLRegion(name, fn, **kw)
