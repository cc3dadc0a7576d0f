"""Deploy-time kernel tuning on the card (counterpart of
``repro/launch/dryrun.py``'s ``--tune``)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --tune \\
        [--tune-bundle PATH] [--tune-buckets 64,256,1024] \\
        [--tune-kernels all|name,...] [--force]

It sweeps the fused MLP over a bundle's serving buckets (or the two
representative NAS widths when no bundle is given), then every
registered kernel's representative problems, and writes the winners
under ``artifacts/tune_torch/``.  It needs a CUDA card.  The sharded dry
run of the reference (``--arch``/``--shape``/``--smoke``) waits for the
port of the distribution layer.
"""
from __future__ import annotations

import argparse


def run_tune(bundle=None, buckets=(64, 256, 1024), force=False,
             kernels="all", device=None):
    """Pre-populate the kernel tune caches
    (``artifacts/tune_torch/<kernel>.json``) so the first real dispatch
    runs the measured-best config: the fused MLP per surrogate bundle,
    then every registered kernel's representative problems."""
    from repro_torch.tune import autotune, autotune_registered
    names = None if kernels in ("all", None) else \
        [k.strip() for k in kernels.split(",") if k.strip()]
    if names is None or "fused_mlp" in names:
        targets = [bundle] if bundle else [[5, 128, 128, 1],
                                           [16, 256, 256, 4]]
        for t in targets:
            recs = autotune(t, list(buckets), force=force, verbose=True,
                            device=device)
            wins = sum(1 for r in recs if r["exact"])
            print(f"[tune] fused_mlp {t}: {wins}/{len(recs)} buckets tuned",
                  flush=True)
        if names is not None:
            names = [k for k in names if k != "fused_mlp"]
            if not names:
                return
    recs = autotune_registered(names, force=force, verbose=True,
                               device=device)
    wins = sum(1 for r in recs if r["exact"])
    print(f"[tune] registered kernels: {wins}/{len(recs)} problems tuned",
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="deploy-time kernel tuning of the port on the card")
    ap.add_argument("--tune", action="store_true",
                    help="sweep the kernels and persist the winners")
    ap.add_argument("--force", action="store_true",
                    help="re-sweep problems that already have a record")
    ap.add_argument("--tune-bundle", default=None,
                    help="--tune: autotune this bundle's widths instead of "
                         "the representative NAS widths")
    ap.add_argument("--tune-buckets", default="64,256,1024",
                    help="--tune: comma-separated batch buckets to sweep")
    ap.add_argument("--tune-kernels", default="all",
                    help="--tune: comma-separated registered kernels to "
                         "sweep, or 'all'")
    args = ap.parse_args(argv)
    if not args.tune:
        ap.error("only --tune is ported so far")
    run_tune(args.tune_bundle,
             [int(b) for b in args.tune_buckets.split(",")],
             force=args.force, kernels=args.tune_kernels)


if __name__ == "__main__":
    main()
