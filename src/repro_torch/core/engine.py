"""Inference engine: loads a model bundle once and serves region
invocations (counterpart of ``repro/core/engine.py``; the Torch-C++ role
in the paper's runtime).

On the f32 tier, a pure-MLP bundle (only ``dense``/``act``/``flatten``
layers) on a CUDA device is served by the hand-written ``fused_mlp``
kernel, its weights packed once at load; the analogue of the JAX
engine's Pallas route on TPU.  Everything else, and every f32 bundle on
the CPU, runs the torch ``Sequential``.  A bundle with ``dropout``
layers is not pure, in both packages.  A pure bundle whose shapes the
kernel cannot take (too wide for shared memory, too many layers) is
routed to ``Sequential`` at load and counted in ``SPEC.unsupported``.
On the CPU a pure-MLP ``Sequential`` runs over fixed tiles of
:data:`CPU_TILE_ROWS` rows (:meth:`InferenceEngine._tiled`), so a row's
output does not depend on its batch there either.

Bundles rewritten on disk are not served stale: :meth:`get` reloads a
bundle whose ``(mtime_ns, size)`` fingerprint changed since load, and
:meth:`invalidate`/:meth:`reload` force it.

Precision tier (resolved once per load, as in the reference): a
pure-MLP bundle whose accuracy gate passed for its current fingerprint
(:mod:`repro_torch.quant.gate`) is served by the int8 tier, its weights
quantized with the verdict's ``scale_mult`` and packed once at load;
``route`` is then ``"fused_mlp_int8"``, the hand-written CUDA kernel on
the card and its plain version on the CPU.  ``REPRO_QUANT`` picks the
mode: ``auto`` (default) serves int8 only on a CUDA device, ``force`` or
``1`` on any device, ``never``/``0``/``off`` pins f32.  Outside
``never`` a failed, stale or missing verdict serves f32, even under
``force``.  A failed int8 launch raises: it never falls back to the f32
kernel or to the plain version.

Serving hooks, as in the reference: :meth:`apply_batched` (what the
serve queue's batcher calls) fires the ``engine.apply`` fault site and
records an ``engine.apply`` span whose ``compile`` flag marks the first
call at a bucket.  A ``corrupt`` fault adds its scale to the weights and
re-packs the ``fused_mlp`` kernel's copy, so the kernel serves the
corrupted weights too; the int8 pack is left alone, as the reference
leaves its load-time int8 layers.  Every load meters the bytes the
engine holds on its device against the residency manager
(:mod:`repro_torch.serve.residency`), and evicted bundles leave through
:meth:`invalidate`.  XLA's buffer donation has no torch counterpart:
``apply_batched`` takes no ``donate``.

Under a mesh (:func:`~repro_torch.dist.sharding.use_mesh`, one rank a
device) the rows are placed on the data axis (:meth:`_place`, the
placement cached per shape and mesh: each rank keeps its own rows of a
batch every rank holds) and served by an apply built once per mesh
(:meth:`_apply_for`): the normalization on the row shards, then the
sharded op of the route, each rank running its kernel on its own rows
(``fused_mlp_sharded``, ``fused_mlp_int8_sharded``; the ``Sequential``
on each rank's rows otherwise).  ``apply_batched`` raises its bucket
floor to the data-shard count, and both entry points return every row
to every rank (an all-gather of the row shards), bit for bit what one
rank would serve; ``apply_batched(gather=False)`` returns the row shards
instead, for the pod path, which reads only its own.  Without a mesh
nothing changes.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import (constrain, current_ctx, distribute,
                                       full_tensor, is_dtensor,
                                       rows_sharded)
from repro_torch.kernels import registry
from repro_torch.kernels.fused_mlp import int8 as int8_ops
from repro_torch.kernels.fused_mlp import ops as fused_ops
from repro_torch.nn.serialize import load_model
from repro_torch.obs import TRACER
from repro_torch.obs import metrics as _m
from repro_torch.quant import gate as quant_gate
from repro_torch.quant.quantize import quantize_params
from repro_torch.resilience.faults import FAULTS
from repro_torch.serve.batcher import bucket_for
from repro_torch.serve.residency import RESIDENCY

_ELIGIBLE = _m.counter("repro_quant_eligible_total",
                       "bundle loads that resolved to the int8 tier",
                       ("bundle",))
_SERVED = _m.counter("repro_quant_served_rows_total",
                     "rows served by the gated int8 tier", ("bundle",))
_VERDICT_ERRORS = _m.counter(
    "repro_quant_verdict_read_errors_total",
    "gate verdicts that could not be read at bundle load (served f32)",
    ("bundle",))


#: rows per tile of a pure-MLP bundle served on the CPU (:meth:`_tiled`)
CPU_TILE_ROWS = 64


def bundle_norm(spec, net, device):
    """The bundle's ``(x_mu, x_sd, y_mu, y_sd)`` normalization tensors on
    ``device``, or None when it was trained unnormalized."""
    extra = spec.get("extra") or {}
    if "x_mu" not in extra:
        return None
    ish = tuple(spec["in_shape"][1:])
    osh = tuple(net.out_shape()[1:])
    return tuple(torch.from_numpy(np.asarray(extra[k], np.float32)
                                  .reshape(s)).to(device)
                 for k, s in (("x_mu", ish), ("x_sd", ish),
                              ("y_mu", osh), ("y_sd", osh)))


def _bundle_mtime(path: str) -> tuple:
    """(mtime_ns, size) fingerprint of the bundle files."""
    newest, total = 0, 0
    for name in ("spec.json", "params.npz"):
        f = os.path.join(path, name)
        if os.path.exists(f):
            stat = os.stat(f)
            newest = max(newest, stat.st_mtime_ns)
            total += stat.st_size
    return (newest, total)


class InferenceEngine:
    _cache: dict = {}
    # guards _cache and in-place reloads: concurrent get() calls on a stale
    # bundle produce exactly one reload, and no reader sees a half-loaded
    # engine.  Reentrant: reload() under get() takes it again.
    _cache_lock = threading.RLock()

    def __init__(self, model_path, device=None):
        self.path = str(model_path)
        self.device = resolve_device(device)
        # buckets already served once since load: a batch at an unseen
        # bucket is marked ``compile`` in its engine.apply span
        self._seen_buckets: set = set()
        # per-mesh applies and row placements (dropped at every load)
        self._applies: dict = {}
        self._shardings: dict = {}
        self._load()

    def _load(self):
        self.net, self.params, self.spec = load_model(self.path, self.device)
        self._mtime = _bundle_mtime(self.path)
        self.norm = bundle_norm(self.spec, self.net, self.device)
        # the tier is a load-time property: the gate verdict is bound to
        # the bundle fingerprint, so any reload resolves it again
        self.tier = self._resolve_tier()
        if self.tier == "int8":
            self.route, self._packed = self._quantize_residency()
        else:
            self.route, self._packed = self._route()
        self._seen_buckets.clear()
        self._applies.clear()
        self._shardings.clear()
        # residency accounting: meter this load's bytes against the LRU
        # byte budget and drop whatever the manager says must go.  The
        # victims leave through invalidate(): eviction and retrain
        # invalidation share one path on purpose.
        self.resident_nbytes = self._resident_nbytes()
        for victim in RESIDENCY.note_load(self.path, self.resident_nbytes):
            type(self).invalidate(victim)

    def _resident_nbytes(self) -> int:
        """Bytes this engine holds on its device for the bundle: the
        parameters, the normalization tensors and the kernel's pack,
        each storage counted once."""
        tensors = list(self.net.parameters()) + list(self.norm or ())
        if self.route == "fused_mlp":
            tensors.append(self._packed.params)
        elif self.route == "fused_mlp_int8":
            tensors += [self._packed.qweights, self._packed.fparams]
            tensors += [t for layer in self._packed.qlayers for t in layer]
        seen = {}
        for t in tensors:
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        return sum(seen.values())

    def _is_pure_mlp(self):
        kinds = [layer["kind"] for layer in self.spec["layers"]]
        return all(k in ("dense", "act", "flatten") for k in kinds)

    def _meta_rows(self):
        """A zero-row meta tensor shaped as the kernel sees the rows."""
        rows = torch.empty((0,) + tuple(self.spec["in_shape"][1:]),
                           device="meta")
        return fused_ops.mlp_stack_from_spec(self.spec, None, rows)[0]

    def _route(self):
        """``("fused_mlp", packed)`` for a pure-MLP bundle on CUDA whose
        shapes the kernel takes, else ``("sequential", None)``."""
        if self.device.type != "cuda" or not self._is_pure_mlp():
            return "sequential", None
        packed = fused_ops.pack_from_spec(self.spec, self.params, self.device)
        if not fused_ops.SPEC.supports(
                fused_ops.inspect_call(self._meta_rows(), packed)):
            fused_ops.SPEC.unsupported += 1
            return "sequential", None
        return "fused_mlp", packed

    def _resolve_tier(self) -> str:
        """Which precision tier this engine serves, resolved once per load
        (``REPRO_QUANT`` modes as in the module docstring).

        A verdict file that cannot be read (``OSError``) or holds a
        malformed record (``ValueError``) serves f32 and is counted in
        ``repro_quant_verdict_read_errors_total``; anything else raises.
        """
        mode = os.environ.get("REPRO_QUANT", "auto").strip().lower()
        if mode in ("never", "0", "off") or not self._is_pure_mlp():
            return "f32"
        if mode not in ("force", "1") and self.device.type != "cuda":
            return "f32"
        try:
            gated = quant_gate.gate_passed(self.path)
        except (OSError, ValueError):
            _VERDICT_ERRORS.inc(1, bundle=self.path)
            return "f32"
        _, weights, _, acts = fused_ops.mlp_stack_from_spec(
            self.spec, self.params, self._meta_rows())
        widths = (int(weights[0].shape[0]),) + tuple(int(w.shape[1])
                                                     for w in weights)
        problem = {"widths": widths, "acts": tuple(acts), "batch": 0,
                   "ndim": 2, "dtype": "float32"}
        return registry.select_tier_spec(fused_ops.SPEC, problem,
                                         gated=gated)[1]

    def _quantize_residency(self):
        """Quantize the dense stack once at load (per-output-channel int8
        weights + f32 scales) with the ``scale_mult`` the gate verdict
        blessed, and pack it for the kernel: serving runs the numbers the
        gate measured.  Returns ``("fused_mlp_int8", packed)``."""
        rec = quant_gate.verdict(self.path) or {}
        _, weights, biases, acts = fused_ops.mlp_stack_from_spec(
            self.spec, self.params, self._meta_rows())
        qlayers = quantize_params(weights, biases,
                                  scale_mult=float(rec.get("scale_mult", 1.0)),
                                  device=self.device)
        _ELIGIBLE.inc(1, bundle=self.path)
        return "fused_mlp_int8", int8_ops.pack_int8_mlp(qlayers, acts)

    @classmethod
    def get(cls, model_path, device=None) -> "InferenceEngine":
        """Process-wide cache keyed by ``(path, device)``: a bundle is
        loaded once per device, and reloaded in place when its on-disk
        fingerprint changes (any change, rollbacks included)."""
        dev = resolve_device(device)
        key = (str(model_path), str(dev))
        with cls._cache_lock:
            eng = cls._cache.get(key)
            if eng is None:
                eng = cls._cache[key] = cls(key[0], dev)
            elif _bundle_mtime(key[0]) != eng._mtime:
                eng.reload()
        RESIDENCY.touch(key[0])
        return eng

    @classmethod
    def invalidate(cls, model_path=None):
        """Drop cached engine(s) so the next get() reloads from disk.

        Residency eviction lands here too: the manager's LRU victims are
        invalidated exactly like a retrained bundle."""
        with cls._cache_lock:
            if model_path is None:
                cls._cache.clear()
            else:
                for key in [k for k in cls._cache if k[0] == str(model_path)]:
                    del cls._cache[key]
        RESIDENCY.drop(model_path)

    def reload(self):
        """Re-read the bundle from disk (and re-pack the kernel's weights)."""
        with self._cache_lock:
            self._load()

    def __call__(self, x):
        """Surrogate rows ``[B, *in_shape[1:]]`` -> outputs, on the
        engine's device, normalized as the bundle says (under a mesh,
        sharded over its data axis, every row back on every rank)."""
        return self._run(x, int(x.shape[0]), current_ctx())

    def _run(self, x, rows: int, ctx, gather: bool = True):
        """:meth:`_serve`, or under a mesh the mesh's apply on the placed
        rows, gathered whole unless ``gather`` is False."""
        if ctx is None or ctx.mesh is None:
            return self._serve(x, rows)
        with torch.no_grad():
            y = self._apply_for(ctx)(self._place(x, ctx))
            if self.route == "fused_mlp_int8":
                _SERVED.inc(rows, bundle=self.path)
            return full_tensor(y) if gather else y

    def _apply_for(self, ctx):
        """The apply for a mesh, built once per ``(mesh, multi_pod)``."""
        key = (ctx.mesh, ctx.multi_pod)
        fn = self._applies.get(key)
        if fn is None:
            fn = self._applies[key] = self._build(ctx)
        return fn

    def _build(self, ctx):
        """The sharded apply: rows constrained to the data axis, the
        normalization (replicated on the mesh) on the row shards, the
        route's sharded op, rows constrained again."""
        from torch.distributed.tensor import Replicate
        mesh, data_axes = ctx.mesh, ctx.mesh_axes_for("data")
        norm = None if self.norm is None else tuple(
            distribute(t, mesh, [Replicate()] * mesh.ndim)
            for t in self.norm)
        if self.route == "fused_mlp_int8":
            def raw(x):
                return int8_ops.fused_mlp_int8_from_spec(
                    self.spec, self._packed, x, mesh=mesh,
                    data_axes=data_axes)
        elif self.route == "fused_mlp":
            def raw(x):
                return fused_ops.fused_mlp_from_spec(
                    self.spec, None, x, packed=self._packed, mesh=mesh,
                    data_axes=data_axes)
        else:
            def raw(x):
                return rows_sharded(self._plain_rows, x, mesh=mesh,
                                    data_axes=data_axes)

        def apply(x):
            rows = ("data",) + (None,) * (x.ndim - 1)
            x = constrain(x, *rows)
            if norm is not None:
                x = (x - norm[0]) / norm[1]
            y = raw(x)
            if norm is not None:
                y = y * norm[3] + norm[2]
            return constrain(y, *(("data",) + (None,) * (y.ndim - 1)))
        return apply

    def _plain_rows(self, x):
        """The ``Sequential`` on rows (in tiles on the CPU)."""
        if self.device.type == "cpu" and self._is_pure_mlp():
            return self._tiled(x)
        return self.net(x)

    def _place(self, x, ctx):
        """Rows placed over the data axis of ``ctx``'s mesh, the
        placements cached per (shape, mesh): every rank holds the batch
        and keeps its own rows.  A DTensor is already placed."""
        if is_dtensor(x):
            return x
        key = (tuple(x.shape), ctx.mesh, ctx.multi_pod)
        if key not in self._shardings:
            self._shardings[key] = ctx.sharding_for(
                tuple(x.shape), ("data",) + (None,) * (x.ndim - 1))
        return distribute(x, ctx.mesh, self._shardings[key])

    @torch.no_grad()
    def _serve(self, x, rows: int):
        """Serve ``x``, of which the first ``rows`` are the caller's (the
        rest bucket padding, not counted as served)."""
        x = x.to(self.device)
        if self.norm is not None:
            x = (x - self.norm[0]) / self.norm[1]
        if self.route == "fused_mlp_int8":
            y = int8_ops.fused_mlp_int8_from_spec(self.spec, self._packed, x)
            _SERVED.inc(rows, bundle=self.path)
        elif self.route == "fused_mlp":
            y = fused_ops.fused_mlp_from_spec(self.spec, None, x,
                                              packed=self._packed)
        else:
            y = self._plain_rows(x)
        if self.norm is not None:
            y = y * self.norm[3] + self.norm[2]
        return y

    def _tiled(self, x):
        """The ``Sequential`` over fixed tiles of :data:`CPU_TILE_ROWS`
        rows, the last zero-padded.  The CPU's BLAS picks its summation
        order from the matrix shape (a matrix-vector product at one row
        or one output column, other blockings elsewhere), so a row's bits
        would depend on the batch it rides in; at one fixed shape they
        do not, which is what the kernels give on the card and what the
        serve queue's bit-identity with synchronous calls rests on."""
        n, t = int(x.shape[0]), CPU_TILE_ROWS
        pad = -n % t
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        y = torch.cat([self.net(x[i:i + t]) for i in range(0, n + pad, t)])
        return y[:n] if pad else y

    def apply_batched(self, x, *, min_bucket: int = 8,
                      prepadded: bool = False, gather: bool = True):
        """Serve a batch padded up to its power-of-two bucket, sliced back
        to the caller's rows.  On the ``fused_mlp`` route the padding is
        invisible to the bit: the kernel never splits a row's sums, so
        rows equal an unpadded :meth:`__call__`'s, and so on the
        ``fused_mlp_int8`` route, where a row's sums are exact integers.
        ``prepadded=True`` says ``x`` is already bucket-shaped (the
        batcher pads while it gathers).  Under a mesh the bucket floor is
        raised to the data-shard count (and rounded to a multiple of it),
        so a batch never loses the data axis to the divisibility
        fallback.  ``gather=False`` under a mesh returns the rows as
        the apply leaves them, a DTensor split over the data axis, with no
        all-gather: the pod path reads its own block of it
        (``Batcher.dispatch_pod``).

        The ``engine.apply`` fault site fires here, once per batch:
        ``raise``/``stall`` act inside the injector, ``nan``/``inf``
        poison every output row, ``corrupt`` perturbs the weights until
        the next load (:meth:`_corrupt`)."""
        n = int(x.shape[0])
        ctx = current_ctx()
        if not prepadded:
            shards = (ctx.axis_size("data")
                      if ctx is not None and ctx.mesh is not None else 1)
            b = bucket_for(n, min_bucket, shards)
            if b != n:
                x = torch.cat([x, x.new_zeros((b - n,) + tuple(x.shape[1:]))])
        fault = None
        if FAULTS.enabled:
            fault = FAULTS.fire("engine.apply", key=self.path)
            if fault is not None and fault.mode == "corrupt":
                self._corrupt(fault.scale)
        if TRACER.enabled:
            bucket = int(x.shape[0])
            with TRACER.span("engine.apply", cat="engine",
                             args={"path": self.path, "rows": n,
                                   "bucket": bucket, "tier": self.tier,
                                   "route": self.route,
                                   "compile": bucket not in
                                   self._seen_buckets}):
                y = self._run(x, n, ctx, gather)
            self._seen_buckets.add(bucket)
        else:
            y = self._run(x, n, ctx, gather)
        if fault is not None and fault.mode in ("nan", "inf"):
            y = y * float(fault.value)
        return y if n == int(y.shape[0]) else y[:n]

    @torch.no_grad()
    def _corrupt(self, scale: float):
        """Add ``scale`` to every weight, persistent until reload (the
        ``corrupt`` fault, which drives the shadow scorer and through it
        the breaker's quality trip).  The ``fused_mlp`` route serves its
        own packed copy, so it is packed again from the corrupted
        weights; the int8 pack stays as loaded, as in the reference."""
        for p in self.net.parameters():
            p.add_(scale)
        if self.route == "fused_mlp":
            self._packed = fused_ops.pack_from_spec(self.spec, self.params,
                                                    self.device)

    def infer_shape(self, in_shape):
        return self.net.out_shape()
