"""Every registered config's kernel problems lie in its kernels' domains.

On the CPU the port's plain versions take any size; on the card a kernel
op raises where its kernel does not take the shape
(``registry.dispatch`` asks ``spec.supports``), and a kernel op without a
backward kernel raises there for an input that requires grad.  So a
config whose widths fall outside a kernel's domain would build, and pass
every CPU test, and fail at its first prefill on the card.  This file
builds, for every config in ``repro_torch/configs/archs.py`` at full
width, the problems its layers hand the kernel ops: a prefill, a decode
step and a training step's forward and backward, in bf16 and f32, from
the config's fields alone (no weights; the tensors live on the ``meta``
device), through each op's own ``inspect_call``:

- GQA (and whisper's encoder, causal as the reference runs it, its
  decoder and its cross attention over the encoder's frames):
  ``flash_attention`` at ``head_dim`` over ``n_kv_heads``;
- MLA: ``flash_attention`` at q.k ``qk_nope_dim + qk_rope_dim`` over v
  ``v_head_dim`` in prefill (its decode step is absorbed and launches
  nothing);
- RWKV6: ``rwkv6_chunk`` at ``rwkv_head_size`` (f32, as the mixer casts),
  in prefill and every decode step;
- Mamba: ``mamba_scan`` at ``mamba_d_state`` in prefill (its step is
  plain torch).

A backward has no spec of its own: ``flash_attention_bwd``,
``rwkv6_chunk_bwd`` and ``mamba_scan_bwd`` each take their forward's
domain (``bwd_takes``: q.k 1 to 256 over v 1 to ``min(hd, 128)``; hd 1
to 128 in f32 and bf16; ds 1 to 16 in f32 and bf16, any S and di).
:data:`KNOWN_OUTSIDE` lists the problems that lie outside today, each
with the queued work that closes it (ROADMAP queue 1, "Backward
kernels"); it is empty now, and the test fails both for a new problem
outside a domain and for a listed one that has come inside, so the list
stays exact.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import archs  # noqa: E402
from repro_torch.configs.base import all_configs  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    bwd_takes)
from repro_torch.kernels.mamba_scan import ops as mamba_ops  # noqa: E402
from repro_torch.kernels.rwkv6_chunk import ops as rwkv_ops  # noqa: E402

PROMPT, CACHE = 2048, 4096   # a prefill's tokens, a decode cache's length
DTYPES = ("bfloat16", "float32")

#: (config, phase, kernel) outside its kernel's domain on the card today,
#: and the work that closes it
KNOWN_OUTSIDE = {}


def _meta(shape, dtype):
    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")


def _attention(sq, skv, h, kv, hd, hdv, dtype, **kw):
    q = _meta((1, sq, h, hd), dtype)
    k = _meta((1, skv, kv, hd), dtype)
    v = _meta((1, skv, kv, hdv), dtype)
    return flash_ops.inspect_call(q, k, v, **kw)


def _layers(cfg):
    """Every layer slot the config runs, encoder slots marked."""
    return ([(spec, False) for spec in (*cfg.prefix, *cfg.pattern)]
            + [(spec, True) for spec in cfg.enc_pattern])


def kernel_problems(cfg, dtype):
    """``[(phase, kernel, problem)]``: every distinct problem the config's
    layers hand a kernel op in a prefill of :data:`PROMPT` tokens, a
    decode step against a cache of :data:`CACHE` and a training step
    (its forward is the prefill's; its backward is named
    ``<kernel>_bwd``)."""
    out = []
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def add(phase, kernel, problem):
        if (phase, kernel, problem) not in out:
            out.append((phase, kernel, problem))

    for spec, encoder in _layers(cfg):
        if spec.mixer == "gqa":
            causal = not encoder
            seq = [(PROMPT, PROMPT, hd, hd, dict(causal=causal))]
            if encoder:
                seq = [(cfg.enc_ctx, cfg.enc_ctx, hd, hd,
                        dict(causal=True))]
            steps = [] if encoder else [
                (1, CACHE, hd, hd, dict(causal=False,
                                        kv_valid_len=CACHE // 2))]
            if spec.cross_attn:
                seq.append((PROMPT, cfg.enc_ctx, hd, hd, dict(causal=False)))
                steps.append((1, cfg.enc_ctx, hd, hd, dict(causal=False)))
            for phase, shapes in (("prefill", seq), ("decode", steps),
                                  ("train", seq)):
                for sq, skv, qk, v, kw in shapes:
                    add(phase, "flash_attention",
                        _attention(sq, skv, H, KV, qk, v, dtype, **kw))
        elif spec.mixer == "mla":
            problem = _attention(PROMPT, PROMPT, H, H,
                                 cfg.qk_nope_dim + cfg.qk_rope_dim,
                                 cfg.v_head_dim, dtype, causal=True)
            add("prefill", "flash_attention", problem)
            add("train", "flash_attention", problem)
        elif spec.mixer == "rwkv6":
            for phase, t in (("prefill", PROMPT), ("decode", 1),
                             ("train", PROMPT)):
                r = _meta((1, t, cfg.n_rwkv_heads, cfg.rwkv_head_size),
                          "float32")
                add(phase, "rwkv6_chunk", rwkv_ops.inspect_call(
                    r, r, r, r, _meta(r.shape[2:], "float32"),
                    _meta((1, cfg.n_rwkv_heads, cfg.rwkv_head_size,
                           cfg.rwkv_head_size), "float32")))
        elif spec.mixer == "mamba":
            di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
            seq = _meta((1, PROMPT, di), dtype)
            rows = _meta((1, PROMPT, ds), dtype)
            problem = mamba_ops.inspect_call(
                seq, seq, rows, rows, _meta((di, ds), "float32"),
                _meta((di,), "float32"), _meta((1, di, ds), "float32"))
            add("prefill", "mamba_scan", problem)
            add("train", "mamba_scan", problem)
        else:
            raise AssertionError(f"{cfg.name}: a mixer this test does not "
                                 f"know, {spec.mixer}: add its kernels")
    return out


SPECS = {"flash_attention": flash_ops.SPEC, "rwkv6_chunk": rwkv_ops.SPEC,
         "mamba_scan": mamba_ops.SPEC}


def outside(phase, kernel, problem):
    """The kernels of ``(phase, kernel, problem)`` whose domain on the card
    it leaves: the forward's ``spec.supports`` and, in training, the
    backward's (``flash_attention_bwd``'s ``bwd_takes``, the forward's
    widths; ``rwkv6_chunk_bwd``'s is the forward's, ``bwd_launch_shape``'s
    hd 1 to 128 in f32 and bf16; ``mamba_scan_bwd``'s is the forward's
    too, ds 1 to ``MAX_STATE`` in f32 and bf16, as its wrapper checks; a
    spec without a backward kernel takes none)."""
    spec = SPECS[kernel]
    found = [] if spec.supports(problem) else [kernel]
    if phase == "train":
        if spec.backward is None:
            found.append(f"{kernel}_bwd")
        elif kernel == "flash_attention" and not bwd_takes(
                problem["hd"], problem.get("hdv", problem["hd"])):
            found.append("flash_attention_bwd")
        elif kernel in ("rwkv6_chunk", "mamba_scan") and not \
                spec.supports(problem):
            found.append(f"{kernel}_bwd")
    return found


def test_every_registered_config_is_checked():
    assert sorted(all_configs()) == sorted(archs.ARCH_NAMES)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", archs.ARCH_NAMES)
def test_config_problems_lie_in_their_kernels_domains(name, dtype):
    cfg = all_configs()[name]
    problems = kernel_problems(cfg, dtype)
    assert problems, f"{name} hands no kernel op a problem"
    found = {(name, phase, k) for phase, kernel, problem in problems
             for k in outside(phase, kernel, problem)}
    known = {key for key in KNOWN_OUTSIDE if key[0] == name}
    assert found == known, (
        f"{name} ({dtype}): outside a kernel's domain {sorted(found)}, "
        f"known {sorted(known)}")


def test_problems_follow_the_configs_widths():
    """Spot checks of what kernel_problems derives: llama's GQA head, MLA's
    wide q.k over v, whisper's cross attention over the encoder context,
    RWKV6's head size and Mamba's state."""
    def problems(name):
        return kernel_problems(all_configs()[name], "bfloat16")
    llama = problems("llama3.2-3b")
    assert [(ph, p["h"], p["kv"], p["hd"], p["sq"]) for ph, _, p in llama] \
        == [("prefill", 24, 8, 128, PROMPT), ("decode", 24, 8, 128, 1),
            ("train", 24, 8, 128, PROMPT)]
    (_, _, mla), _ = problems("deepseek-v2-lite-16b")
    assert (mla["hd"], mla["hdv"], mla["h"], mla["kv"]) == (192, 128, 16, 16)
    whisper = problems("whisper-medium")
    assert {(p["sq"], p["skv"], p["hd"]) for _, _, p in whisper} == {
        (PROMPT, PROMPT, 64), (1, CACHE, 64), (PROMPT, 1500, 64),
        (1, 1500, 64), (1500, 1500, 64)}
    rwkv = problems("rwkv6-1.6b")
    assert [(ph, p["hd"], p["h"], p["t"]) for ph, _, p in rwkv] == [
        ("prefill", 64, 32, PROMPT), ("decode", 64, 32, 1),
        ("train", 64, 32, PROMPT)]
    scans = [p for _, k, p in problems("jamba-v0.1-52b") if k == "mamba_scan"]
    assert scans and all((p["ds"], p["di"]) == (16, 8192) for p in scans)


def test_a_config_outside_a_domain_is_found():
    """The guard sees a config past a kernel's domain (a Mamba state of
    17, a GQA head of 192 with v as wide, an RWKV6 head of 192, forward
    and backward, an MLA q.k head past 256), and MLA inside it at q.k 128
    over v 128 as at its own 192 over 128."""
    jamba = all_configs()["jamba-v0.1-52b"]
    wide_state = {(ph, k) for ph, kernel, p in kernel_problems(
        jamba.replace(mamba_d_state=17), "bfloat16")
        for k in outside(ph, kernel, p)}
    assert wide_state == {("prefill", "mamba_scan"), ("train", "mamba_scan"),
                          ("train", "mamba_scan_bwd")}
    llama = all_configs()["llama3.2-3b"]
    wide = {(ph, k) for ph, kernel, p in kernel_problems(
        llama.replace(head_dim=192), "bfloat16")
        for k in outside(ph, kernel, p)}
    assert wide == {(ph, k) for ph in ("prefill", "decode", "train")
                    for k in ("flash_attention",)} | {
                        ("train", "flash_attention_bwd")}
    rwkv = all_configs()["rwkv6-1.6b"]
    wide_rwkv = {(ph, k) for ph, kernel, p in kernel_problems(
        rwkv.replace(rwkv_head_size=192), "bfloat16")
        for k in outside(ph, kernel, p)}
    assert wide_rwkv == {(ph, "rwkv6_chunk") for ph in (
        "prefill", "decode", "train")} | {("train", "rwkv6_chunk_bwd")}
    narrow = all_configs()["deepseek-v2-lite-16b"].replace(qk_nope_dim=64)
    assert [k for ph, kernel, p in kernel_problems(narrow, "bfloat16")
            for k in outside(ph, kernel, p)] == []
    wide_mla = all_configs()["deepseek-v2-lite-16b"].replace(qk_nope_dim=200)
    assert {(ph, k) for ph, kernel, p in kernel_problems(wide_mla, "float32")
            for k in outside(ph, kernel, p)} == {
                ("prefill", "flash_attention"), ("train", "flash_attention"),
                ("train", "flash_attention_bwd")}
