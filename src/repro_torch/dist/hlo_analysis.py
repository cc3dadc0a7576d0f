"""Collective accounting and roofline estimation at the H100's peaks
(counterpart of ``repro/dist/hlo_analysis.py``).

``collective_stats`` counts the collectives a sharded program issues and
the bytes each moves on the wire, per rank, by the reference's rules
(``hlo_analysis.py:88-128``):

  * all-gather       -> full gathered (output) size
  * reduce-scatter   -> full reduced (operand) size
  * all-reduce       -> 2x tensor size (ring = reduce-scatter + all-gather)
  * all-to-all /
    collective-permute -> tensor size, counted once

i.e. max(in, out) bytes, doubled for an all-reduce; ``corrected_bytes``
re-prices f32/f64 at 2 bytes an element, as the reference does for its
CPU dry run.  Torch has no HLO: where the reference parses a compiled
module, the port records each functional collective DTensor issues
while the program runs (:class:`~repro_torch.dist.comm.CollectiveMode`),
under the reference's kind names.  DTensor defers a reduction as a
``Partial`` placement until something needs its value, so only
collectives that materialise count: a measured step must end in its
real outputs.

``Roofline`` turns (FLOPs, HBM bytes, collective bytes) into the three
classic time terms against per-card peaks and reports the dominant
bottleneck, the step-time bound and the achievable-MFU bound; its
arithmetic is the reference's.  The defaults are one NVIDIA H100 SXM5
80 GB's (NVIDIA's data sheet, dense rates at the 700 W limit), where the
reference's are a TPU v5e's.

"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict

import torch

_WIRE_F32_AS_BF16 = {torch.float32: 2, torch.float64: 2}


@dataclasses.dataclass
class CollectiveStats:
    """Per-kind collective counts and wire bytes (one rank's)."""

    per_kind_count: Dict[str, int] = dataclasses.field(default_factory=dict)
    per_kind_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    per_kind_corrected: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return float(sum(self.per_kind_bytes.values()))

    @property
    def corrected_bytes(self) -> float:
        """Total bytes with f32/f64 re-priced as bf16 on the wire."""
        return float(sum(self.per_kind_corrected.values()))

    def add(self, kind: str, n_in: int, n_out: int, dtype) -> None:
        """Count one collective of ``n_in`` elements in and ``n_out`` out
        of ``dtype``."""
        size = torch.empty((), dtype=dtype).element_size()
        for width, acc in ((size, self.per_kind_bytes),
                           (_WIRE_F32_AS_BF16.get(dtype, size),
                            self.per_kind_corrected)):
            b = max(n_in, n_out) * width
            if kind == "all-reduce":
                b *= 2
            acc[kind] = acc.get(kind, 0) + b
        self.per_kind_count[kind] = self.per_kind_count.get(kind, 0) + 1

    def __str__(self) -> str:
        parts = [f"{k}: n={self.per_kind_count[k]} "
                 f"{self.per_kind_bytes[k]/1e9:.3f}GB"
                 for k in sorted(self.per_kind_count)]
        return "CollectiveStats(" + ", ".join(parts) + ")"


@contextlib.contextmanager
def collective_stats():
    """``with collective_stats() as st:`` counts into ``st`` every
    collective the body's DTensor ops issue on this rank (and its
    autograd backward, which inherits the mode)."""
    from repro_torch.dist.comm import collectives
    st = CollectiveStats()
    with collectives(st):
        yield st


# NVIDIA H100 SXM5 80 GB, data sheet, dense.  The port's f32 fused_mlp
# runs its products as 3xTF32 on the tensor cores (three TF32 products a
# multiply-add), so its f32 rate is the TF32 peak over three: the rate
# PERF.md's 3xTF32 bound of fused_mlp (1.656 ms at 65,536 minibude rows)
# is priced at.
PEAK_FLOPS = 494.7e12 / 3   # FLOP/s, 3xTF32 on the tensor cores
HBM_BW = 3.35e12            # bytes/s, HBM3 of the H100 SXM5 80 GB
ICI_BW = 450e9              # bytes/s a direction, NVLink 4 (H100 SXM5)


@dataclasses.dataclass
class Roofline:
    """Three-term roofline over *global* (all-card) resource totals.

    model_flops is the analytic useful work (6ND / 2ND); a counted FLOP
    total may include recompute, so useful_flops_fraction < 1 and the
    achievable MFU is bounded by useful-compute-time / step-time.
    """

    flops_global: float
    hbm_bytes_global: float
    coll_bytes_global: float
    chips: int
    model_flops: float
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    ici_bw: float = ICI_BW

    @property
    def compute_s(self) -> float:
        return self.flops_global / self.chips / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_global / self.chips / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_global / self.chips / self.ici_bw

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_fraction(self) -> float:
        if not self.flops_global:
            return 0.0
        return self.model_flops / self.flops_global

    @property
    def mfu_bound(self) -> float:
        """Best achievable MFU at the roofline step time."""
        if self.step_time_s <= 0:
            return 0.0
        useful_s = self.model_flops / self.chips / self.peak_flops
        return useful_s / self.step_time_s

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "step_time_s": self.step_time_s,
            "dominant": self.dominant,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu_bound": self.mfu_bound,
            "chips": self.chips,
            "flops_global": self.flops_global,
            "hbm_bytes_global": self.hbm_bytes_global,
            "coll_bytes_global": self.coll_bytes_global,
        }
