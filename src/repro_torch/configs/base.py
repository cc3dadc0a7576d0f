"""Model/config system (counterpart of ``repro/configs/base.py``).

A copy of the reference's module: the reference imports ``jax.numpy``
for ``jdtype``, so the port cannot import it.  Fields, derived
properties, parameter counting, shape cells and the registry are the
reference's; ``jdtype`` becomes :attr:`ModelConfig.torch_dtype`.

Every assigned architecture is expressed as a :class:`ModelConfig` built from
a *layer pattern*: a period ``P`` of :class:`LayerSpec` slots repeated ``R``
times (``n_layers = len(prefix) + P*R``).  Homogeneous archs have ``P=1``;
hybrids (jamba) encode their interleave in the pattern; deepseek's first
dense layer lives in ``prefix``.  The pattern-scan keeps HLO size constant in
depth, which matters for 1-core dry-run compiles and mirrors how production
frameworks (MaxText et al.) scan over layers.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch


@dataclass(frozen=True)
class LayerSpec:
    """One slot in the layer pattern."""

    mixer: str = "gqa"  # gqa | mla | rwkv6 | mamba
    mlp: str = "swiglu"  # swiglu | gelu | moe | rwkv_cm
    cross_attn: bool = False  # enc-dec decoder layers


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 512
    vocab_size: int = 1024
    # --- layer pattern ---
    pattern: Sequence[LayerSpec] = (LayerSpec(),)
    prefix: Sequence[LayerSpec] = ()
    # --- attention options ---
    qkv_bias: bool = False
    qk_norm: bool = False
    rope: str = "rope"  # rope | mrope | none
    rope_theta: float = 1e4
    mrope_sections: Sequence[int] = (16, 24, 24)
    # --- norm / act ---
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu (swiglu) | gelu
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # --- MLA (deepseek) ---
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- mamba ---
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0  # 0 -> d_model // 16
    # --- rwkv ---
    rwkv_head_size: int = 64
    rwkv_lora_dim: int = 32
    # --- enc-dec (whisper) ---
    enc_dec: bool = False
    enc_layers: int = 0
    enc_ctx: int = 1500
    enc_pattern: Sequence[LayerSpec] = ()
    # --- vlm ---
    needs_position_ids: bool = False
    # --- numerics / memory policy ---
    dtype: str = "bfloat16"
    # optimizer state policy: "full"   = fp32 master + fp32 (m, v)
    #                         "lean"   = no master, bf16 (m, v)  (giant models)
    opt_policy: str = "full"
    remat: bool = True
    attn_chunk: int = 1024  # flash/chunked attention KV block
    scan_layers: bool = True
    max_pos: int = 32768  # learned-pos table length (rope='none' archs)
    kv_cache_dtype: str = "bfloat16"  # 'int8' -> quantized KV cache (decode)
    # paper technique in the LM: serve-time FFN surrogate (approx-ml region
    # inlined as a first-class config; interleave accurate/surrogate decode
    # steps like MiniWeather timesteps in paper Observation 4)
    ffn_surrogate_dim: int = 0
    unroll_inner: bool = False  # unroll inner chunk scans (dry-run calibration)
    # --- which shape cells support sub-quadratic long ctx ---
    subquadratic: bool = False

    # ----- derived -----
    @property
    def pattern_repeats(self) -> int:
        body = self.n_layers - len(self.prefix)
        assert body % len(self.pattern) == 0, (
            f"{self.name}: {body} layers not divisible by pattern period "
            f"{len(self.pattern)}"
        )
        return body // len(self.pattern)

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or max(1, self.d_model // 16)

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    @property
    def padded_vocab(self) -> int:
        """Vocab padded so logits shard 16-ways (and to a lane multiple)."""
        mult = 128
        return ((self.vocab_size + mult - 1) // mult) * mult

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (analytic; used for roofline MODEL_FLOPS) ----
    def param_counts(self) -> dict:
        """Returns dict with 'total' and 'active' (per-token) param counts."""
        d, hd = self.d_model, self.head_dim
        total = 0
        active = 0

        def mixer_params(spec: LayerSpec) -> int:
            if spec.mixer == "gqa":
                q = d * self.n_heads * hd + (self.n_heads * hd if self.qkv_bias else 0)
                kv = 2 * (d * self.n_kv_heads * hd + (self.n_kv_heads * hd if self.qkv_bias else 0))
                o = self.n_heads * hd * d
                qkn = 2 * hd if self.qk_norm else 0
                return q + kv + o + qkn
            if spec.mixer == "mla":
                r = self.kv_lora_rank
                q = d * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                dkv = d * r + d * self.qk_rope_dim
                ukv = r * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                o = self.n_heads * self.v_head_dim * d
                return q + dkv + ukv + o
            if spec.mixer == "rwkv6":
                ld = self.rwkv_lora_dim
                proj = 5 * d * d  # r k v g o  (w via lora)
                lora = d * ld * 6 + ld * d * 6 + 2 * d  # shift/decay loras + w0/u
                return proj + lora
            if spec.mixer == "mamba":
                di, ds, dc = self.mamba_d_inner, self.mamba_d_state, self.mamba_d_conv
                inp = d * 2 * di
                conv = di * dc
                xproj = di * (self.dt_rank + 2 * ds)
                dtp = self.dt_rank * di
                out = di * d
                ssm = di * ds + di  # A_log, D
                return inp + conv + xproj + dtp + out + ssm
            raise ValueError(spec.mixer)

        def mlp_params(spec: LayerSpec):
            if spec.mlp == "swiglu":
                return 3 * d * self.d_ff, 3 * d * self.d_ff
            if spec.mlp == "gelu":
                return 2 * d * self.d_ff, 2 * d * self.d_ff
            if spec.mlp == "rwkv_cm":
                return 2 * d * self.d_ff, 2 * d * self.d_ff
            if spec.mlp == "moe":
                e_ff = self.moe_d_ff or self.d_ff
                per_e = 3 * d * e_ff
                tot = self.n_experts * per_e + self.n_shared_experts * per_e + d * self.n_experts
                act = (self.top_k + self.n_shared_experts) * per_e + d * self.n_experts
                return tot, act
            raise ValueError(spec.mlp)

        layers = list(self.prefix) + list(self.pattern) * self.pattern_repeats
        for spec in layers:
            m = mixer_params(spec)
            mt, ma = mlp_params(spec)
            x = 0
            if spec.cross_attn:
                x = 2 * d * self.n_kv_heads * hd + d * self.n_heads * hd + self.n_heads * hd * d
            total += m + mt + x + 2 * d  # + norms
            active += m + ma + x + 2 * d
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else d * self.vocab_size
        total += emb + head + d
        active += emb + head + d
        if self.enc_dec:
            enc = 0
            for spec in self.enc_pattern * (self.enc_layers // max(1, len(self.enc_pattern))):
                enc += mixer_params(spec) + mlp_params(spec)[0] + 2 * d
            total += enc
            active += enc
        return {"total": int(total), "active": int(active)}


@dataclass(frozen=True)
class ShapeCell:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        load_all()
    return _REGISTRY[name]


def all_configs() -> dict:
    if not _REGISTRY:
        load_all()
    return dict(_REGISTRY)


def load_all() -> None:
    # importing the modules registers their configs
    from repro_torch.configs import archs  # noqa: F401


def cell_supported(cfg: ModelConfig, shape: ShapeCell) -> tuple[bool, str]:
    """Assignment rules: long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "skipped(full-attention)"
    return True, ""


def with_repeats(cfg: ModelConfig, repeats: int) -> ModelConfig:
    """Shrink the pattern-repeat count (dry-run cost calibration)."""
    kw = dict(n_layers=len(cfg.prefix) + len(cfg.pattern) * repeats)
    if cfg.enc_dec:
        kw["enc_layers"] = len(cfg.enc_pattern) * repeats
    return cfg.replace(**kw)
