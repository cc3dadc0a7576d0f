"""Kernel registry: one declaration per hand-written kernel, one dispatcher
(counterpart of ``repro/kernels/registry.py``, trimmed to what the port's
kernels use so far).

Dispatch is decided by where the data lies:

* a CPU tensor takes the kernel's plain PyTorch version;
* a CUDA tensor takes the kernel, or raises.  No failure is caught and
  answered with the plain version.

``supports(problem)`` keeps its JAX meaning: a shape the kernel cannot
take is routed by the caller (the inference engine) to the torch
``Sequential``, decided from shapes before any launch and counted in
``KernelSpec.unsupported``.  Tunable parameters resolve explicit >
defaults; tuned winners wait for the port of the tuner.

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
from typing import Callable, Dict, List, Optional, Tuple

SMEM_PER_BLOCK = 232_448  # bytes a Hopper block can use


def round_up(n: int, m: int) -> int:
    return n + (-n % m)


@dataclasses.dataclass(frozen=True)
class TunableParam:
    """One tunable kernel parameter and its candidate ladder."""
    name: str
    default: int
    ladder: Tuple[int, ...]


@dataclasses.dataclass
class KernelSpec:
    """Declaration the registry dispatches.

    * ``kernel`` is the launching wrapper (CUDA tensors only); it carries
      the plain-integer launch count ``kernel.launches``, raised where it
      launches and nowhere else;
    * ``run_call(problem, arrays, params)`` calls ``kernel``;
    * ``ref_call(problem, arrays)`` is the plain PyTorch version;
    * ``fits(problem, params)`` is the shared-memory model;
    * ``supports(problem)`` says whether the kernel takes the shape at all;
    * ``tier`` is the precision tier, ``"f32"`` or ``"int8"``.  An int8
      variant is held against its own int8-simulating plain version;
      accuracy against f32 is the quant gate's concern
      (:mod:`repro_torch.quant.gate`).
    """
    name: str
    params: Tuple[TunableParam, ...]
    kernel: Callable
    run_call: Callable
    ref_call: Callable
    fits: Callable
    supports: Callable
    tol: Tuple[float, float]
    tier: str = "f32"
    plain_calls: int = 0
    unsupported: int = 0

    @property
    def launches(self) -> int:
        return self.kernel.launches

    def reset_counts(self) -> None:
        self.kernel.launches = 0
        self.plain_calls = 0
        self.unsupported = 0


_SPECS: Dict[str, KernelSpec] = {}
_BUILTIN_OPS = ("repro_torch.kernels.fused_mlp.ops",
                "repro_torch.kernels.fused_mlp.int8")


def register(spec: KernelSpec) -> KernelSpec:
    _SPECS[spec.name] = spec
    return spec


def all_specs() -> List[KernelSpec]:
    import importlib
    for mod in _BUILTIN_OPS:
        importlib.import_module(mod)
    return [_SPECS[k] for k in sorted(_SPECS)]


def reset_counts() -> None:
    for spec in all_specs():
        spec.reset_counts()


def resolve_params(spec: KernelSpec, problem: dict,
                   overrides: Optional[dict] = None) -> Dict[str, int]:
    """Explicit overrides win, else each parameter's default, stepped down
    its ladder to the largest value that fits.  An explicit value that
    does not fit raises."""
    overrides = {k: v for k, v in (overrides or {}).items() if v is not None}
    params: Dict[str, int] = {}
    for p in spec.params:
        if p.name in overrides:
            params[p.name] = int(overrides[p.name])
            if not spec.fits(problem, params):
                raise ValueError(f"{spec.name}: {p.name}={params[p.name]} "
                                 f"does not fit {problem}")
            continue
        for v in sorted((v for v in p.ladder if v <= p.default),
                        reverse=True):
            if spec.fits(problem, dict(params, **{p.name: v})):
                params[p.name] = v
                break
        else:
            raise ValueError(f"{spec.name}: no {p.name} fits {problem}")
    return params


def quantized_variant(spec: KernelSpec) -> Optional[KernelSpec]:
    """The registered int8 twin of a base spec (``<name>_int8``), or None
    when the kernel has no quantized variant."""
    all_specs()
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


def dispatch(spec: KernelSpec, problem: dict, arrays: tuple, device, *,
             overrides: Optional[dict] = None):
    """Run ``spec`` on ``arrays``, which lie on ``device``: the plain
    version on the CPU, the kernel on CUDA (or raise)."""
    if device.type == "cpu":
        spec.plain_calls += 1
        return spec.ref_call(problem, arrays)
    if device.type != "cuda":
        raise ValueError(f"{spec.name}: no kernel for device {device}")
    if not spec.supports(problem):
        raise ValueError(f"{spec.name}: the kernel does not take {problem}")
    return spec.run_call(problem, arrays,
                         resolve_params(spec, problem, overrides))
