"""Tensor map: memory concretization (counterpart of
``repro/core/tensor_map.py``; paper §IV-A, Fig. 4) over torch tensors.

Direction ``to`` gathers application memory into the LHS-shaped tensor;
``from`` writes a tensor back through the functor windows.  The JAX
semantics are kept exactly:

* a gather window must lie inside the array, as ``lax.slice`` demands
  (torch slicing would silently clip it, so it is checked and raises);
* ``from_tensor`` is functional: it returns a new tensor and never
  writes into the caller's;
* each window write clamps an out-of-range start into the array, as
  ``lax.dynamic_update_slice`` does.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Sequence

import torch

from repro_torch.core.functor import SSlice, TensorFunctor


def _normalize_ranges(functor: TensorFunctor, ranges) -> dict:
    syms = functor.sweep_symbols
    if isinstance(ranges, dict):
        out = {}
        for k, v in ranges.items():
            if isinstance(v, range):
                out[k] = (v.start, v.stop, v.step)
            else:
                t = tuple(v)
                out[k] = t if len(t) == 3 else (t[0], t[1], 1)
        return out
    out = {}
    for s, v in zip(syms, ranges):
        t = tuple(v) if not isinstance(v, range) else (v.start, v.stop, v.step)
        out[s] = t if len(t) == 3 else (t[0], t[1], 1)
    return out


@dataclass(frozen=True)
class SliceDescriptor:
    """One RHS slice after extraction/resolution (paper's runtime struct)."""
    offsets: tuple          # per-dim start offset at the sweep origin
    window_shape: tuple     # per-dim window extent (sweep dims) or 1
    sweep_dims: tuple       # which array dim each sweep symbol drives (or None)
    elem_offsets: tuple     # per-feature additional offsets within the slice
    steps: tuple            # per-dim stride (sweep step * symbol coeff)


def symbolic_shape_extraction(group: Sequence[SSlice], ranges: dict):
    """Offsets + element counts for one RHS slice group."""
    offsets, elem_axes = [], []
    for s in group:
        syms = s.start.symbols
        if len(syms) > 1:
            raise ValueError("an s-slice may use at most one s-constant")
        base = {n: ranges[n][0] for n in syms}
        offsets.append(s.start.evaluate(base))
        elem_axes.append(s.n_elements())
    return tuple(offsets), tuple(elem_axes)


def symbolic_shape_resolution(group: Sequence[SSlice], ranges: dict):
    """Window shape + sweep-dim mapping + strides for one slice group."""
    shape, sweep_dims, steps = [], [], []
    for s in group:
        syms = s.start.symbols
        if syms:
            name = syms[0]
            coeff = dict(s.start.coeffs)[name]
            lo, hi, st = ranges[name]
            shape.append(max(0, -(-(hi - lo) // st)))
            sweep_dims.append(name)
            steps.append(st * coeff)
        else:
            shape.append(1)
            sweep_dims.append(None)
            steps.append(1)
    return tuple(shape), tuple(sweep_dims), tuple(steps)


def tensor_wrapping(group: Sequence[SSlice], ranges: dict) -> SliceDescriptor:
    offsets, elem_axes = symbolic_shape_extraction(group, ranges)
    shape, sweep_dims, steps = symbolic_shape_resolution(group, ranges)
    elem_offsets = tuple(itertools.product(
        *[range(0, n * max(1, s.step), max(1, s.step)) if n > 1 else (0,)
          for n, s in zip(elem_axes, group)]))
    return SliceDescriptor(offsets, shape, sweep_dims, elem_offsets, steps)


def _gather_group(array: torch.Tensor, desc: SliceDescriptor):
    """All shifted windows for one slice group -> [sweep..., n_elem]."""
    views = []
    for eo in desc.elem_offsets:
        index = []
        for d in range(len(desc.offsets)):
            start = desc.offsets[d] + eo[d]
            extent = desc.window_shape[d]
            step = desc.steps[d] if desc.sweep_dims[d] is not None else 1
            stride = abs(step) if extent > 1 else 1
            limit = start + (extent - 1) * stride + 1 if extent > 1 \
                else start + 1
            if start < 0 or limit > array.shape[d]:
                raise ValueError(
                    f"window [{start}:{limit}] of dim {d} lies outside an "
                    f"array of shape {tuple(array.shape)}")
            index.append(slice(start, limit, stride))
        v = array[tuple(index)]
        views.append(v.reshape([s for s in v.shape if s != 1] or [1]))
    return torch.stack(views, dim=-1)


class TensorMap:
    """A functor applied to concrete memory over concrete ranges."""

    def __init__(self, functor: TensorFunctor, array, ranges,
                 direction: str = "to"):
        if direction not in ("to", "from"):
            raise ValueError(f"direction must be 'to' or 'from', got "
                             f"{direction!r}")
        self.functor = functor
        self.array = array
        self.ranges = _normalize_ranges(functor, ranges)
        self.direction = direction
        self.descriptors = [tensor_wrapping(g, self.ranges)
                            for g in functor.rhs]

    # ------------------------------------------------------ to tensor -----
    def to_tensor(self, array=None):
        """Tensor composition: app memory -> LHS-shaped tensor."""
        array = self.array if array is None else array
        parts = [_gather_group(array, d) for d in self.descriptors]
        return self._compose_lhs(torch.cat(parts, dim=-1))

    def _lhs_dims(self):
        sweep, feat = [], []
        for s in self.functor.lhs:
            if s.start.symbols:
                name = s.start.symbols[0]
                lo, hi, st = self.ranges[name]
                sweep.append(max(0, -(-(hi - lo) // st)))
            else:
                feat.append(s.n_elements())
        return sweep, feat

    def _compose_lhs(self, t):
        sweep, feat = self._lhs_dims()
        want_feat = 1
        for f in feat:
            want_feat *= f
        if t.shape[-1] != want_feat:
            raise ValueError(
                f"functor {self.functor.name}: LHS declares {want_feat} "
                f"features, RHS provides {t.shape[-1]}")
        if not feat:
            return t.reshape(tuple(sweep) + (1,))[..., 0]
        return t.reshape(tuple(sweep) + tuple(feat))

    @property
    def tensor_shape(self):
        sweep, feat = self._lhs_dims()
        return tuple(sweep) + tuple(feat)

    # ---------------------------------------------------- from tensor -----
    def from_tensor(self, tensor, array=None):
        """Write the tensor back through the functor windows into a copy
        of the array (each window's start clamped into the array)."""
        array = self.array if array is None else array
        sweep, _ = self._lhs_dims()
        flat = tensor.reshape(tuple(sweep) + (-1,))
        out = array.clone()
        fidx = 0
        for desc in self.descriptors:
            for eo in desc.elem_offsets:
                shape = list(desc.window_shape)
                piece = flat[..., fidx].reshape(shape)
                index = []
                for d, n in enumerate(shape):
                    if n > out.shape[d]:
                        raise ValueError(
                            f"a window of {n} does not fit dim {d} of an "
                            f"array of shape {tuple(out.shape)}")
                    start = desc.offsets[d] + eo[d]
                    start = min(max(start, 0), out.shape[d] - n)
                    index.append(slice(start, start + n))
                out[tuple(index)] = piece.to(out.dtype)
                fidx += 1
        return out

    def min_array_shape(self):
        """Smallest app-memory shape the windows cover (template synth)."""
        nd = len(self.descriptors[0].offsets)
        hi = [0] * nd
        for desc in self.descriptors:
            for eo in desc.elem_offsets:
                for d in range(nd):
                    step = abs(desc.steps[d]) if desc.sweep_dims[d] else 1
                    end = (desc.offsets[d] + eo[d]
                           + (desc.window_shape[d] - 1) * step + 1)
                    hi[d] = max(hi[d], end)
        return tuple(hi)

    def __repr__(self):
        return (f"TensorMap({self.functor.name}, dir={self.direction}, "
                f"ranges={self.ranges}, tensor_shape={self.tensor_shape})")
