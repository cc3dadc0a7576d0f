"""Batched LM serving: prefill a batch of prompts, then decode greedily
(the loop of ``examples/serve_lm.py`` as a function).

    PYTHONPATH=src python -m repro_torch.launch.serve_lm [--arch NAME]

serves ``rwkv6-1.6b`` (or ``--arch``, e.g. ``llama3.2-3b``, whose
attention runs on the ``flash_attention`` kernel,
``deepseek-v2-lite-16b``, MLA + MoE, 15.7 B parameters, whose prefill
attention runs on it at q.k 192 / v 128, ``jamba-v0.1-52b``, Mamba +
GQA + MoE, whose prefill scans run on the ``mamba_scan`` kernel, or
``whisper-medium``, whose encoder, decoder and cross attention all run
on ``flash_attention``) at full width with seeded random weights on the
card (4 random prompts of 2,048 tokens, 384 for an encoder-decoder model
within whisper's 448-token text context, and 33 generated tokens) and
prints one JSON line of host times.  An encoder-decoder model gets
seeded frame embeddings ``[4, enc_ctx, d_model]`` (the reference's stub
frontend: the repository ships no audio).
Any config the port builds and the card holds serves unchanged: jamba's
four periods (52 B parameters, 104 GB in bf16) exceed one card, and
``chip_smoke.py`` serves one period of its pattern
(``configs.base.with_repeats``) through :func:`generate`;
``repro_torch.examples.serve_lm`` is the small demo, and serves a
reduced config with ``--arch``.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.models import lm


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, prompts, gen, *, enc_embeds=None):
    """``prefill`` over ``prompts`` ``[B, S]`` (and, for an
    encoder-decoder model, the encoder over ``enc_embeds`` ``[B, Se,
    d]``), then ``gen - 1`` greedy ``serve_step`` calls: ``gen`` new
    tokens per prompt, the first from the prefill's logits.  Text prompts
    under mrope take position ``t`` in all three components.  Returns a
    dict with ``tokens`` ``[B, gen]``, the last ``logits`` ``[B, Vp]``,
    and host seconds ``prefill_s`` and ``decode_s``, each ended by a
    device synchronize."""
    dev = params["tok_embed"].device
    prompts = prompts.to(dev)
    B, S = prompts.shape
    pid = (torch.arange(S, device=dev).expand(3, B, S)
           if cfg.rope == "mrope" else None)
    if enc_embeds is not None:
        enc_embeds = enc_embeds.to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = lm.prefill(cfg, params, prompts, position_ids=pid,
                                enc_embeds=enc_embeds, cache_len=S + gen)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    tok = logits.argmax(-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = lm.serve_step(cfg, params, caches, tok, S + i)
        tok = logits.argmax(-1)[:, None]
        out.append(tok)
    _sync(dev)
    return {"tokens": torch.cat(out, dim=1), "logits": logits,
            "prefill_s": t_prefill, "decode_s": time.perf_counter() - t0}


#: an encoder-decoder model's prompt: whisper's decoder reads 448 text
#: positions, so 384 prompt tokens and the 33 generated fit
ENC_DEC_PROMPT = 384


def enc_embeds_for(cfg, batch, generator):
    """Seeded frame embeddings ``[batch, cfg.enc_ctx, cfg.d_model]`` in
    the model's dtype on the generator's device (the reference's stub
    frontend), or None for a decoder-only config."""
    if not cfg.enc_dec:
        return None
    return torch.randn((batch, cfg.enc_ctx, cfg.d_model), generator=generator,
                       device=generator.device).to(cfg.torch_dtype)


def main(argv=None, batch=4, prompt_len=2048, gen=33, seed=0):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6-1.6b",
                    help="a registered config the port builds")
    cfg = get_config(ap.parse_args(argv).arch)
    if cfg.enc_dec:
        prompt_len = min(prompt_len, ENC_DEC_PROMPT)
    params = lm.init_params(seed, cfg)
    dev = params["tok_embed"].device
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=g, device=dev)
    enc_embeds = enc_embeds_for(cfg, batch, g)
    res = generate(cfg, params, prompts, gen, enc_embeds=enc_embeds)
    print(json.dumps({
        "arch": cfg.name, "batch": batch, "prompt_len": prompt_len,
        "enc_frames": cfg.enc_ctx if cfg.enc_dec else 0,
        "gen": gen, "prefill_s": res["prefill_s"],
        "decode_s": res["decode_s"],
        "decode_ms_per_step": res["decode_s"] / (gen - 1) * 1e3,
        "tokens_per_s": batch * (gen - 1) / res["decode_s"],
        "device": torch.cuda.get_device_name(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
