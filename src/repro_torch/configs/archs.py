"""The 10 assigned architectures (a copy of ``repro/configs/archs.py``).

Sources ([tier]): whisper-medium [arXiv:2212.04356], rwkv6-1.6b
[arXiv:2404.05892], qwen1.5-{32b,110b} [hf:Qwen/Qwen1.5-*], llama3.2-3b
[hf:meta-llama], qwen3-4b [hf:Qwen/Qwen3-*], jamba-v0.1-52b
[arXiv:2403.19887], qwen2-vl-7b [arXiv:2409.12191], deepseek-v2-lite-16b
[arXiv:2405.04434], grok-1-314b [hf:xai-org/grok-1].
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, register

A = LayerSpec  # shorthand

register(ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51865,
    pattern=(A(mixer="gqa", mlp="gelu", cross_attn=True),),
    enc_dec=True, enc_layers=24, enc_ctx=1500,
    enc_pattern=(A(mixer="gqa", mlp="gelu"),),
    qkv_bias=True, rope="none", norm="layernorm", act="gelu",
))

register(ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=7168, vocab_size=65536,
    pattern=(A(mixer="rwkv6", mlp="rwkv_cm"),),
    rope="none", norm="layernorm",
    rwkv_head_size=64, subquadratic=True,
))

register(ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
    d_ff=27392, vocab_size=152064,
    pattern=(A(),), qkv_bias=True, rope_theta=1e6,
))

register(ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=128256,
    pattern=(A(),), rope_theta=5e5, tie_embeddings=True,
))

register(ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, vocab_size=151936,
    pattern=(A(),), qk_norm=True, rope_theta=1e6, tie_embeddings=True,
))

register(ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=49152, vocab_size=152064,
    pattern=(A(),), qkv_bias=True, rope_theta=1e6,
))

# Jamba: attn:mamba 1:7 interleave (attn at slot 4 of an 8-layer period),
# MoE every other layer (even slots), 16 experts top-2.
register(ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    pattern=(
        A(mixer="mamba", mlp="moe"), A(mixer="mamba", mlp="swiglu"),
        A(mixer="mamba", mlp="moe"), A(mixer="mamba", mlp="swiglu"),
        A(mixer="gqa", mlp="moe"), A(mixer="mamba", mlp="swiglu"),
        A(mixer="mamba", mlp="moe"), A(mixer="mamba", mlp="swiglu"),
    ),
    n_experts=16, top_k=2, moe_d_ff=14336,
    rope="none",  # jamba uses no positional encoding
    subquadratic=True,
))

register(ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064,
    pattern=(A(),), qkv_bias=True, rope="mrope", rope_theta=1e6,
    mrope_sections=(16, 24, 24), needs_position_ids=True,
))

# DeepSeek-V2-Lite: MLA (kv_lora 512), first layer dense (d_ff 10944),
# remaining 26 layers MoE: 64 routed top-6 + 2 shared experts, expert ff 1408.
register(ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944, vocab_size=102400,
    prefix=(A(mixer="mla", mlp="swiglu"),),
    pattern=(A(mixer="mla", mlp="moe"),),
    n_experts=64, top_k=6, n_shared_experts=2, moe_d_ff=1408,
    kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
))

register(ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab_size=131072,
    pattern=(A(mixer="gqa", mlp="moe"),),
    n_experts=8, top_k=2, moe_d_ff=32768, act="gelu",
    opt_policy="lean",
))

ARCH_NAMES = [
    "whisper-medium", "rwkv6-1.6b", "qwen1.5-32b", "llama3.2-3b",
    "qwen3-4b", "qwen1.5-110b", "jamba-v0.1-52b", "qwen2-vl-7b",
    "deepseek-v2-lite-16b", "grok-1-314b",
]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    kw = dict(
        n_layers=len(cfg.prefix) + 2 * len(cfg.pattern),
        d_model=64, n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16, d_ff=128, vocab_size=256,
        rwkv_head_size=16, kv_lora_rank=32 if cfg.kv_lora_rank else 0,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        mamba_dt_rank=8, moe_d_ff=32 if cfg.n_experts else 0,
        n_experts=min(cfg.n_experts, 4), top_k=min(cfg.top_k, 2),
        enc_layers=2 if cfg.enc_dec else 0, enc_ctx=16,
        attn_chunk=32, opt_policy="full", max_pos=128,
        name=cfg.name + "-smoke",
    )
    if cfg.rope == "mrope":
        kw["mrope_sections"] = (2, 3, 3)  # scaled to head_dim 16 (half=8)
    if cfg.n_experts:
        # no capacity drops in smoke tests -> train/decode paths match exactly
        kw["capacity_factor"] = float(min(cfg.n_experts, 4))
    if cfg.n_kv_heads == cfg.n_heads:
        kw["n_kv_heads"] = 4
    return cfg.replace(**kw)
