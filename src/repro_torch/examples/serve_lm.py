"""Batched LM serving demo on the port (twin of ``examples/serve_lm.py``):
prefill + decode with KV caches.

Runs a small llama-style model (GQA + swiglu), or with ``--arch`` the
reduced form of a registered config (``archs.reduced``: e.g.
deepseek-v2-lite-16b's MLA + MoE, grok-1-314b's GQA + MoE, which at
full size fits no single card, jamba-v0.1-52b's Mamba + GQA + MoE
with learned positions, or whisper-medium's encoder and cross attention
over seeded frame embeddings), prefills a batch of prompts, then decodes
tokens greedily through ``serve_step``; attention runs on the
``flash_attention`` kernel on the card, and Mamba's prefill scan on
``mamba_scan``.  The reference jits its decode step; the port's runs
eagerly.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm \
          [--device cpu] [--arch grok-1-314b]
"""
import argparse
import time

import torch

from repro_torch.configs.archs import reduced
from repro_torch.configs.base import LayerSpec, ModelConfig, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve_lm import enc_embeds_for, generate
from repro_torch.models import lm

CFG = ModelConfig(name="serve-demo", n_layers=4, d_model=256, n_heads=8,
                  n_kv_heads=4, head_dim=32, d_ff=1024, vocab_size=8192,
                  pattern=(LayerSpec(),))
BATCH, PROMPT_LEN, GEN = 4, 32, 48


def serve_demo(*, device=None, arch=None):
    """Seeded weights and prompts, then ``GEN`` greedy tokens for each of
    ``BATCH`` prompts of ``PROMPT_LEN`` tokens (and, for an
    encoder-decoder model, seeded frame embeddings), of ``CFG`` or the
    reduced ``arch``: the dict of
    :func:`~repro_torch.launch.serve_lm.generate`."""
    cfg = CFG if arch is None else reduced(get_config(arch))
    dev = resolve_device(device)
    params = lm.init_params(0, cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                            generator=g, device=dev)
    return generate(cfg, params, prompts, GEN,
                    enc_embeds=enc_embeds_for(cfg, BATCH, g))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--arch", default=None,
                    help="serve this registered config, reduced (default: "
                         "the demo's llama-style model)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    res = serve_demo(device=args.device, arch=args.arch)
    total = time.perf_counter() - t0
    print(f"prefill {BATCH}x{PROMPT_LEN} in {res['prefill_s'] * 1e3:.1f}ms; "
          f"decoded {GEN} tokens in {res['decode_s'] * 1e3:.1f}ms "
          f"({BATCH * GEN / res['decode_s']:.0f} tok/s; {total:.2f}s with "
          f"weights)")
    print("sample:", res["tokens"][0, :16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
