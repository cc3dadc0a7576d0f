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
  has a database, when false);
* ``infer_async`` -- (serving) enqueue the bridged rows on a
  :class:`repro_torch.serve.ServeQueue` and return an
  :class:`AsyncRegionResult`; many callers' requests coalesce into one
  batch before inference.

A ``serving=`` queue can also be attached to a ``predicated`` region:
the ML path then defers through the queue and both branches return an
:class:`AsyncRegionResult`, so the caller's interface is uniform.

Resilience, as in the reference: while a bundle's circuit breaker
(:mod:`repro_torch.resilience.breaker`) is OPEN, inference is served by
the accurate path instead (``_fallback``, counted per bundle and path in
``repro_resilience_fallback_total``); a failed synchronous inference,
and an async result whose dispatch failed (an injected fault, a
non-finite screen, a dead dispatcher), degrade the same way and count a
breaker failure.  With the breaker board disabled the failure raises.
Sampled requests are shadow-scored against the accurate path on a
background thread (:mod:`repro_torch.obs.quality`).

The accurate path's wall time is taken on the host around work that ends
in ``torch.cuda.synchronize()`` when the region runs on CUDA.  The
reference's traced path (both branches in one program under
``lax.cond``, collection through ``io_callback``) has no eager torch
counterpart.
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
from repro_torch.obs import TRACER
from repro_torch.obs.quality import SHADOW
from repro_torch.resilience.breaker import BREAKERS


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class AsyncRegionResult:
    """Deferred region invocation handle (``infer_async`` / serving).

    ``result()`` blocks on the serve future (flushing on demand when the
    queue has no dispatcher thread), moves the rows to the region's
    device and runs the output data bridge in the caller's thread, so
    bridging is paid by whoever consumes the result, not by the
    dispatcher.
    """

    __slots__ = ("_region", "_arrays", "_future", "_done", "_deferred")

    def __init__(self, region, arrays, future=None, resolved=None):
        self._region, self._arrays = region, arrays
        self._future = future
        self._deferred = future is not None
        self._done = resolved  # pre-resolved outputs (accurate path)

    def done(self) -> bool:
        return self._done is not None or self._future.done()

    def deferred(self) -> bool:
        """True when this invocation actually went through the queue."""
        return self._deferred

    def result(self, timeout: Optional[float] = None) -> dict:
        if self._done is None:
            region = self._region
            try:
                Y = self._future.result(timeout)
            except TimeoutError:
                raise  # not a surrogate failure: the caller set the budget
            except Exception:
                # zero-lost contract: a failed dispatch (injected fault,
                # non-finite screen, dead dispatcher) degrades to the
                # accurate path instead of surfacing the serve error
                if not (BREAKERS.enabled and region.model_path):
                    raise
                BREAKERS.record_failure(region.model_path)
                self._done = region._fallback(self._arrays, "result")
                self._future = None
                return self._done
            self._done = region.bridge_from(Y.to(region.device),
                                            self._arrays)
            # the future holds a view of the batch's landing buffer: let
            # it go, so the batcher's pool can hand the buffer out again
            self._future = None
        return self._done


class MLRegion:
    def __init__(self, name: str, fn: Callable, *,
                 inputs: Dict[str, Tuple[TensorFunctor, dict]],
                 outputs: Dict[str, Tuple[TensorFunctor, dict]],
                 mode: str = "predicated",
                 model: Optional[str] = None,
                 database=None,
                 serving=None,
                 device=None):
        if mode not in ("collect", "infer", "predicated", "infer_async"):
            raise ValueError(f"region {name}: unknown mode {mode!r}")
        if mode == "infer_async" and serving is None:
            raise ValueError(f"region {name}: mode='infer_async' needs a "
                             f"serving= queue")
        self.name, self.fn, self.mode = name, fn, mode
        self.inputs, self.outputs = inputs, outputs
        self.model_path = model
        self.serving = serving  # repro_torch.serve.ServeQueue (or None)
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

    def _fallback(self, arrays: dict, path: str) -> dict:
        """Serve this invocation from the accurate path (breaker OPEN or
        a dispatch failure), wearing the surrogate's output contract."""
        BREAKERS.note_fallback(self.model_path, path)
        with TRACER.span("resilience.fallback", cat="region",
                         args={"region": self.name, "key": self.model_path,
                               "path": path}):
            return self._accurate(arrays, collect=False)

    def _infer(self, arrays: dict):
        use_breaker = BREAKERS.enabled and self.model_path is not None
        if use_breaker and not BREAKERS.allow(self.model_path):
            return self._fallback(arrays, "infer")
        try:
            eng, Xb = self._rows_in(arrays)
            Y = eng(Xb)
        except Exception:
            if not use_breaker:
                raise
            BREAKERS.record_failure(self.model_path)
            return self._fallback(arrays, "infer")
        if use_breaker:
            BREAKERS.record_success(self.model_path)
        if SHADOW.enabled and SHADOW.sample():
            self._shadow_submit(arrays, rows=int(Xb.shape[0]), Y=Y)
        return self.bridge_from(Y, arrays)

    def _infer_async(self, arrays: dict) -> AsyncRegionResult:
        """Enqueue this invocation on the serve queue, keyed
        (multiplexed) by bundle path."""
        if (BREAKERS.enabled and self.model_path is not None
                and not BREAKERS.allow(self.model_path)):
            # breaker OPEN (or HALF_OPEN non-probe): resolve through the
            # accurate path immediately, same handle contract
            return AsyncRegionResult(
                self, arrays,
                resolved=self._fallback(arrays, "infer_async"))
        eng, Xb = self._rows_in(arrays)
        del eng  # resolved for bundle load/reload; the batcher gets per batch
        fut = self.serving.submit(self.model_path, Xb)
        if SHADOW.enabled and SHADOW.sample():
            self._shadow_submit(arrays, rows=int(Xb.shape[0]), future=fut)
        return AsyncRegionResult(self, arrays, future=fut)

    def _shadow_submit(self, arrays: dict, *, rows: int, Y=None,
                       future=None) -> None:
        """Capture this sampled invocation for background accuracy
        scoring: the surrogate's output rows against the accurate
        function's bridged output over a *copy* of the inputs (the app
        may write into its buffers after the region returns).  The
        accurate replay runs later on the scorer's worker thread."""
        snap = {k: v.detach().clone() for k, v in arrays.items()}
        if future is not None:
            pred = lambda: _host(future.result(60.0))  # noqa: E731
            trace = future.trace
        else:
            pred = lambda: _host(Y)  # noqa: E731
            trace = None

        def ref():
            with torch.no_grad():
                return _host(self.bridge_out_tensors(self.fn(**snap)))

        SHADOW.submit(self.model_path, pred=pred, ref=ref,
                      region=self.name, rows=rows, trace=trace)

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
        if self.mode == "infer_async":
            return self._infer_async(arrays)
        if predicate is None:
            raise ValueError(f"region {self.name}: a predicated region "
                             f"needs a predicate")
        if self.serving is not None:
            # serving hook: the ML path defers through the queue; the
            # accurate path resolves now but wears the same handle, so
            # callers need not branch on the predicate
            if bool(predicate):
                return self._infer_async(arrays)
            return AsyncRegionResult(
                self, arrays,
                resolved=self._accurate(arrays, collect=self.db is not None))
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
