"""Kernel registry: one declaration per hand-written kernel, one dispatcher
(counterpart of ``repro/kernels/registry.py``).

Dispatch is decided by where the data lies:

* a CPU tensor takes the kernel's plain PyTorch version;
* a CUDA tensor takes the kernel, or raises.  No failure is caught and
  answered with the plain version.

Gradients: a spec with a ``backward`` is differentiable on both devices
(:class:`_Differentiable`), through one output or a tuple of them: when
grad mode is on and an input requires grad, its backward runs the
backward kernel on the card and the plain backward on the CPU.  A
backward may keep residuals: under grad its spec's forward then also
returns tensors that are saved for the backward and never reach the
caller (:class:`Backward`'s ``keep_run`` / ``keep_ref``).  On the card a spec without one raises
``NotImplementedError`` for such inputs rather than return an output
that autograd cannot see past (the kernel's output has no ``grad_fn``);
on the CPU its plain version differentiates through autograd as before.

``supports(problem)`` keeps its JAX meaning: a shape the kernel cannot
take is routed by the caller (the inference engine) to the torch
``Sequential``, decided from shapes before any launch and counted in
``KernelSpec.unsupported``.  Tunable parameters resolve explicit > tuned
> default (:func:`resolve_params_info`), tuned winners coming from the
port's tune cache (:mod:`repro_torch.tune.cache`), which
:mod:`repro_torch.tune.kernel_tuner` fills on the card.  Every dispatch
is counted in ``repro_kernel_dispatch_total`` by kernel, provenance and
tier, as in the reference.

Each spec names its precision ``tier`` (``"f32"``, or ``"int8"`` for a
quantized variant registered as ``<base>_int8``), and
:func:`select_tier_spec` picks the tier one dispatch site serves.

The TPU VMEM model becomes a Hopper shared-memory model: a block may use
at most 227 KB (232,448 bytes) of dynamic shared memory, and anything
above 48 KB must be opted into by the launcher
(``cudaFuncAttributeMaxDynamicSharedMemorySize``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.obs import TRACER
from repro_torch.obs import metrics as _m
from repro_torch.resilience.faults import FAULTS

SMEM_PER_BLOCK = 232_448  # bytes a Hopper block can use
BACKEND = "cuda"          # the backend string in tune-cache keys

_DISPATCHES = _m.counter(
    "repro_kernel_dispatch_total",
    "kernel dispatches by resolved-params provenance and precision tier",
    ("kernel", "provenance", "tier"))


def round_up(n: int, m: int) -> int:
    return n + (-n % m)


@dataclasses.dataclass(frozen=True)
class TunableParam:
    """One tunable kernel parameter and its candidate ladder."""
    name: str
    default: int
    ladder: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Backward:
    """The backward of a kernel: ``run_call(problem, arrays, out, grad)``
    launches ``kernel`` (the wrapper, with its plain-integer count
    ``kernel.launches``) and ``ref_call`` with the same arguments is the
    plain backward; both return one gradient (or None) per array.  For a
    kernel with one output, ``out`` is that output and ``grad`` its
    cotangent; for a kernel that returns a tuple, both are tuples, one
    entry per output.  A cotangent autograd did not compute (an output
    the loss does not reach) arrives as zeros: autograd materialises
    it.

    Where the backward starts from what its forward computed (the scan's
    states before each chunk), ``keep_run(problem, arrays, params)`` and
    ``keep_ref(problem, arrays)`` are the forward on the card and on the
    CPU under grad: each returns ``(out, residuals)``, ``out`` what
    ``run_call`` / ``ref_call`` of the spec return and ``residuals`` a
    tuple of tensors.  They are saved beside the inputs and outputs, kept
    from the caller, and passed to the backward after ``grad``:
    ``run_call(problem, arrays, out, grad, *residuals)``.  Without them
    (None, both) the forward is the spec's own and the backward takes
    four arguments."""
    kernel: Callable
    run_call: Callable
    ref_call: Callable
    keep_run: Optional[Callable] = None
    keep_ref: Optional[Callable] = None


@dataclasses.dataclass
class KernelSpec:
    """Declaration the registry dispatches and the tuner sweeps.

    A call splits into a static ``problem`` dict (shapes, dtype name,
    config such as ``acts`` or ``causal``: what keys the tune cache and
    synthesizes sweep inputs) and the positional ``arrays`` tuple.

    * ``kernel`` is the launching wrapper (CUDA tensors only); it carries
      the plain-integer launch count ``kernel.launches``, raised where it
      launches and nowhere else;
    * ``run_call(problem, arrays, params)`` calls ``kernel``;
    * ``ref_call(problem, arrays)`` is the plain PyTorch version;
    * ``make_call(problem, generator, device) -> arrays`` builds the
      inputs of a sweep from a seeded ``torch.Generator``;
    * ``cache_key(problem, backend)`` keys the tune cache, and the
      optional ``cache_keys`` gives ordered lookup fallbacks (the fused
      MLP tries the exact batch before the pow2 bucket);
    * ``candidates(problem)`` lists the sweep's param dicts, defaults
      first;
    * ``fits(problem, params)`` is the shared-memory (and register) model;
    * ``supports(problem)`` says whether the kernel takes the shape at all;
    * ``tol`` is ``(rtol, atol)`` against the plain version on the card,
      ``None`` for bit-exact;
    * ``tier`` is the precision tier, ``"f32"`` or ``"int8"``.  An int8
      variant is held against its own int8-simulating plain version;
      accuracy against f32 is the quant gate's concern
      (:mod:`repro_torch.quant.gate`);
    * ``backward``, where the kernel has one, makes dispatch
      differentiable (:class:`Backward`);
    * ``parts`` are the wrappers of the kernels ``kernel`` launches
      through, where it has more than one, each with its own
      ``launches`` count (flash attention: f32, bf16 prefill, bf16 decode
      and its combine);
    * ``problem_defaults(problem)``, where set, gives the tunables'
      defaults for a problem in place of the params' own (flash
      attention's differ by dtype: one design for each).
    """
    name: str
    params: Tuple[TunableParam, ...]
    kernel: Callable
    run_call: Callable
    ref_call: Callable
    make_call: Callable
    cache_key: Callable
    candidates: Callable
    fits: Callable
    supports: Callable
    cache_keys: Optional[Callable] = None
    tol: Optional[Tuple[float, float]] = None
    tier: str = "f32"
    default_problems: Tuple[dict, ...] = ()
    backward: Optional[Backward] = None
    parts: Tuple[Callable, ...] = ()
    problem_defaults: Optional[Callable] = None
    plain_calls: int = 0
    unsupported: int = 0

    @property
    def launches(self) -> int:
        return self.kernel.launches

    def reset_counts(self) -> None:
        self.kernel.launches = 0
        if self.backward is not None:
            self.backward.kernel.launches = 0
        for part in self.parts:
            part.launches = 0
        self.plain_calls = 0
        self.unsupported = 0

    def defaults(self, problem: Optional[dict] = None) -> Dict[str, int]:
        if problem is not None and self.problem_defaults is not None:
            return dict(self.problem_defaults(problem))
        return {p.name: p.default for p in self.params}

    def lookup_keys(self, problem: dict, backend: str = BACKEND) -> List[str]:
        if self.cache_keys is not None:
            return list(self.cache_keys(problem, backend))
        return [self.cache_key(problem, backend)]


_SPECS: Dict[str, KernelSpec] = {}
_BUILTIN_OPS = ("repro_torch.kernels.fused_mlp.ops",
                "repro_torch.kernels.fused_mlp.int8",
                "repro_torch.kernels.flash_attention.ops",
                "repro_torch.kernels.flash_attention.int8",
                "repro_torch.kernels.mamba_scan.ops",
                "repro_torch.kernels.rwkv6_chunk.ops",
                "repro_torch.kernels.stencil_gather.ops")


def register(spec: KernelSpec) -> KernelSpec:
    _SPECS[spec.name] = spec
    return spec


def ensure_builtin_specs() -> None:
    """Import the kernel packages so their specs self-register."""
    import importlib
    for mod in _BUILTIN_OPS:
        importlib.import_module(mod)


def get_spec(name: str) -> KernelSpec:
    ensure_builtin_specs()
    try:
        return _SPECS[name]
    except KeyError:
        raise KeyError(f"unknown kernel {name!r}; registered: "
                       f"{sorted(_SPECS)}") from None


def all_specs() -> List[KernelSpec]:
    ensure_builtin_specs()
    return [_SPECS[k] for k in sorted(_SPECS)]


def reset_counts() -> None:
    for spec in all_specs():
        spec.reset_counts()


def ladder_candidates(spec_params: Sequence[TunableParam],
                      clip: Optional[Dict[str, int]] = None,
                      fits: Optional[Callable] = None,
                      defaults: Optional[Dict[str, int]] = None
                      ) -> List[dict]:
    """Cartesian product of the params' ladders, defaults first (the
    params' own unless ``defaults`` names them), each axis clipped to
    ``clip[name]`` (inclusive; the default always stays), filtered by
    ``fits``.

    Defaults first matters: the sweep measures the all-defaults combo as
    the baseline every winner's speedup is reported against, and ties
    keep the default.
    """
    clip, defaults = clip or {}, defaults or {}
    combos: List[dict] = [{}]
    for p in spec_params:
        hi, first = clip.get(p.name), defaults.get(p.name, p.default)
        vals = [first] + [int(v) for v in p.ladder
                          if v != first and (hi is None or v <= hi)]
        combos = [dict(c, **{p.name: v}) for c in combos for v in vals]
    return [c for c in combos if fits is None or fits(c)]


def fitting_defaults(spec: KernelSpec, problem: dict) -> Dict[str, int]:
    """The spec's defaults, stepped down until they fit this card: the
    largest parameter drops one rung of its ladder at a time.  Raises
    when nothing on the ladders fits."""
    params = spec.defaults(problem)
    while not spec.fits(problem, params):
        lower = {p.name: max((v for v in p.ladder if v < params[p.name]),
                             default=None) for p in spec.params}
        lower = {k: v for k, v in lower.items() if v is not None}
        if not lower:
            raise ValueError(f"{spec.name}: no parameters fit {problem}")
        name = max(lower, key=lambda k: (params[k], k))
        params[name] = lower[name]
    return params


def tuned_params(spec: KernelSpec, problem: dict) -> Dict[str, int]:
    """Validated tune-cache winner for ``problem``, or {} when untuned
    (a record that is not ``exact`` never resolves)."""
    if not spec.params:
        return {}
    from repro_torch.tune.cache import best_params
    return best_params(spec.name, spec.lookup_keys(problem)) or {}


def resolve_params_info(spec: KernelSpec, problem: dict,
                        overrides: Optional[dict] = None
                        ) -> Tuple[Dict[str, int], str]:
    """Explicit overrides > tuned winners > spec defaults, re-checked
    against this card's shared-memory model: a tuned (or caller-supplied)
    config that does not fit serves the defaults instead, stepped down
    until they fit (:func:`fitting_defaults`).

    Returns ``(params, provenance)``; the provenance (``explicit``,
    ``tuned``, ``default`` or ``default:smem-fallback``, the first two
    mixed as ``explicit+tuned``) is what each dispatch is counted under.
    Untuned defaults that do not fit are stepped down too, under
    ``default``.
    """
    overrides = {k: v for k, v in (overrides or {}).items() if v is not None}
    defaults = spec.defaults(problem)
    tuned = None
    params: Dict[str, int] = {}
    sources = set()
    for p in spec.params:
        if p.name in overrides:
            params[p.name] = int(overrides[p.name])
            sources.add("explicit")
            continue
        if tuned is None:
            tuned = tuned_params(spec, problem)
        if p.name in tuned:
            params[p.name] = int(tuned[p.name])
            sources.add("tuned")
        else:
            params[p.name] = defaults[p.name]
            sources.add("default")
    provenance = "+".join(s for s in ("explicit", "tuned", "default")
                          if s in sources) or "default"
    if params and not spec.fits(problem, params):
        if provenance != "default":
            provenance = "default:smem-fallback"
        params = fitting_defaults(spec, problem)
    return params, provenance


def resolve_params(spec: KernelSpec, problem: dict,
                   overrides: Optional[dict] = None) -> Dict[str, int]:
    return resolve_params_info(spec, problem, overrides)[0]


def quantized_variant(spec: KernelSpec) -> Optional[KernelSpec]:
    """The registered int8 twin of a base spec (``<name>_int8``), or None
    when the kernel has no quantized variant."""
    ensure_builtin_specs()
    return _SPECS.get(spec.name + "_int8")


def select_tier_spec(spec: KernelSpec, problem: Optional[dict] = None, *,
                     gated: bool, explicit: Optional[str] = None
                     ) -> Tuple[KernelSpec, str]:
    """Precision-tier resolution for one dispatch site, in the
    reference's order: explicit > quantized-if-gated > base.

    * ``explicit="f32"`` pins the base spec; ``explicit="int8"`` serves
      the variant whenever it exists and supports the problem, bypassing
      the gate (direct testing only);
    * otherwise the int8 variant serves only when the bundle's accuracy
      gate passed (``gated=True``) and the variant's ``supports``
      accepts the problem;
    * anything else falls through to the base spec.

    Returns ``(spec_to_dispatch, tier)``.
    """
    if explicit == "f32":
        return spec, spec.tier
    q = quantized_variant(spec)
    if q is None or (explicit != "int8" and not gated):
        return spec, spec.tier
    if problem is not None and not q.supports(problem):
        return spec, spec.tier
    return q, q.tier


class _Differentiable(torch.autograd.Function):
    """A dispatch whose backward is the spec's: the kernel's backward on
    the card, the plain backward on the CPU.  The kernel returns one
    output or a tuple of them; every output is saved and carries a
    ``grad_fn``, and so are the residuals of a backward that keeps them
    (saved only).  An input that needs no gradient
    (``ctx.needs_input_grad``) gets None."""

    @staticmethod
    def forward(ctx, spec, problem, device, overrides, *arrays):
        keep = spec.backward.keep_run is not None
        out = _dispatch(spec, problem, arrays, device, overrides, keep=keep)
        out, residuals = out if keep else (out, ())
        ctx.spec, ctx.problem, ctx.device = spec, problem, device
        ctx.n_arrays, ctx.several = len(arrays), isinstance(out, tuple)
        outs = out if ctx.several else (out,)
        ctx.n_outs = len(outs)
        ctx.save_for_backward(*arrays, *outs, *residuals)
        return out

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        n, m = ctx.n_arrays, ctx.n_arrays + ctx.n_outs
        arrays, outs, residuals = saved[:n], saved[n:m], saved[m:]
        grads = tuple(g.contiguous() for g in grads)
        if not ctx.several:
            outs, grads = outs[0], grads[0]
        bwd = ctx.spec.backward
        call = bwd.ref_call if ctx.device.type == "cpu" else bwd.run_call
        found = call(ctx.problem, tuple(arrays), outs, grads, *residuals)
        return (None, None, None, None,
                *(g if need else None
                  for g, need in zip(found, ctx.needs_input_grad[4:])))


def _needs_grad(arrays) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in arrays)


def dispatch(spec: KernelSpec, problem: dict, arrays: tuple, device, *,
             overrides: Optional[dict] = None):
    """Run ``spec`` on ``arrays``, which lie on ``device``: the plain
    version on the CPU (counted under provenance ``ref``), the kernel
    with resolved parameters on CUDA (or raise).

    Where grad mode is on and an input requires grad, a spec with a
    ``backward`` runs under :class:`_Differentiable`; on CUDA a spec
    without one raises ``NotImplementedError``.

    The ``kernel.dispatch`` fault site fires first, and a
    ``kernel.dispatch`` instant marks the call in a trace, as in the
    reference; dispatch is eager here, so both happen once per call
    (the reference's once per jit trace)."""
    if _needs_grad(arrays):
        if spec.backward is not None:
            return _Differentiable.apply(spec, problem, device, overrides,
                                         *arrays)
        if device.type == "cuda":
            raise NotImplementedError(
                f"{spec.name}: the kernel has no backward on the card yet "
                f"(ROADMAP queue 1, 'Backward kernels'), and an input "
                f"requires grad; call it under torch.no_grad(), or on the "
                f"CPU, where its plain version differentiates")
    return _dispatch(spec, problem, arrays, device, overrides)


def _dispatch(spec: KernelSpec, problem: dict, arrays: tuple, device,
              overrides: Optional[dict], keep: bool = False):
    """The dispatch itself; with ``keep`` (under grad, a backward that
    keeps residuals) the forward is the backward's ``keep_run`` /
    ``keep_ref`` and returns ``(out, residuals)``."""
    run = spec.backward.keep_run if keep else spec.run_call
    ref = spec.backward.keep_ref if keep else spec.ref_call
    if FAULTS.enabled:
        FAULTS.fire("kernel.dispatch", key=spec.name)
    if device.type == "cpu":
        spec.plain_calls += 1
        _DISPATCHES.inc(1, kernel=spec.name, provenance="ref",
                        tier=spec.tier)
        if TRACER.enabled:
            TRACER.instant("kernel.dispatch", cat="kernel",
                           args={"kernel": spec.name, "path": "ref",
                                 "tier": spec.tier})
        return ref(problem, arrays)
    if device.type != "cuda":
        raise ValueError(f"{spec.name}: no kernel for device {device}")
    if not spec.supports(problem):
        raise ValueError(f"{spec.name}: the kernel does not take {problem}")
    params, provenance = resolve_params_info(spec, problem, overrides)
    _DISPATCHES.inc(1, kernel=spec.name, provenance=provenance,
                    tier=spec.tier)
    if TRACER.enabled:
        TRACER.instant("kernel.dispatch", cat="kernel",
                       args={"kernel": spec.name, "params": dict(params),
                             "provenance": provenance, "tier": spec.tier})
    return run(problem, arrays, params)
