"""End-to-end LM training on the port (twin of
``examples/train_lm.py``):

  * deterministic seekable data pipeline,
  * atomic/async checkpointing + exact resume,
  * straggler watchdog (p99 step-time flagging),
  * optional int8 error-feedback gradient compression,
  * optional simulated mid-run failure (--simulate-failure, exit 17) to
    exercise the recovery path.

The default config is a ~20M-param llama-style model; --preset 100m
gives the ~100M one.  Attention runs on the ``flash_attention`` kernel
and its backward on the card.  The reference jits its step; the port's
runs eagerly.  A checkpoint is named by the steps it has completed, so a
resumed run starts with the next step and replays none (the reference
names it by the last step run and runs that step again on resume).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
      [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.train import trainer
from repro_torch.train.compression import (ef_compress, init_residual,
                                           wire_bytes)

PRESETS = {
    "20m": dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
                head_dim=32, d_ff=1024, vocab_size=8192),
    "100m": dict(n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
                 head_dim=64, d_ff=2048, vocab_size=32768),
}
FAILURE_EXIT = 17


def preset_config(preset: str) -> ModelConfig:
    return ModelConfig(name=f"lm-{preset}", pattern=(LayerSpec(),),
                       **PRESETS[preset])


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="20m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default="artifacts/train_lm_ckpt_torch")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--simulate-failure", action="store_true",
                    help="crash once 60%% of the steps are done; rerun to "
                         "resume")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def train(args, *, on_step=None, log=print):
    """Train as ``args`` say, resuming from the latest checkpoint under
    ``args.ckpt_dir``.  ``on_step(step, state, metrics)`` runs after each
    step.  Returns ``{"start", "losses", "times", "state"}``; raises
    ``SystemExit(17)`` at the simulated failure, after its checkpoint."""
    dev = resolve_device(args.device)
    cfg = preset_config(args.preset)
    n = cfg.param_counts()["total"]
    log(f"model {cfg.name}: {n/1e6:.1f}M params")

    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch, seed=7)
    state = trainer.make_train_state(0, cfg, device=dev)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start = 0
    if mgr.latest_step() is not None:
        state, start = trainer.restore_train_state(mgr, cfg, state)
        log(f"resumed from checkpoint at step {start}")

    compress = None
    if args.grad_compress:
        residual = init_residual(state["params"])
        un, comp = wire_bytes(state["params"])
        log(f"grad compression: {un/1e6:.1f}MB -> {comp/1e6:.1f}MB on the "
            f"cross-pod wire per step")

        def compress(grads):
            nonlocal residual
            g, residual = ef_compress(grads, residual)
            return g

    times, losses = [], {}
    fail_at = int(args.steps * 0.6)
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        batch = trainer.to_device(pipe.batch_at(step), dev)
        state, metrics = trainer.train_step(cfg, state, batch,
                                            grad_compress=compress)
        loss = float(metrics["loss"])  # waits for the step
        dt = time.perf_counter() - t0
        times.append(dt)
        losses[step] = loss
        if on_step is not None:
            on_step(step, state, metrics)
        # straggler watchdog: flag steps beyond p99 of the trailing window
        if len(times) > 20:
            p99 = float(np.percentile(times[-50:], 99))
            if dt > max(2 * np.median(times[-50:]), p99 * 1.5):
                log(f"  [watchdog] step {step} took {dt*1e3:.0f}ms "
                    f"(p99 {p99*1e3:.0f}ms) — straggler flagged")
        if step % 20 == 0 or step == args.steps - 1:
            log(f"step {step:4d} loss {loss:.4f} "
                f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
        done = step + 1
        if done % args.ckpt_every == 0 and done < args.steps:
            trainer.save_train_state(mgr, done, state)
        if args.simulate_failure and done == fail_at and start == 0:
            trainer.save_train_state(mgr, done, state)
            mgr.wait()
            log(f"simulated failure after step {step} — rerun to resume")
            raise SystemExit(FAILURE_EXIT)
    trainer.save_train_state(mgr, args.steps, state)
    mgr.wait()
    if times:
        log(f"done; median step {np.median(times)*1e3:.0f}ms; "
            f"checkpoints in {args.ckpt_dir}")
    return {"start": start, "losses": losses, "times": times,
            "state": state}


def main(argv=None):
    train(parser().parse_args(argv), log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
