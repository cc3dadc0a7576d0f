"""The sharded dry run and deploy-time kernel tuning (counterpart of
``repro/launch/dryrun.py``)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --smoke \\
        [--device cpu] [--force]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --tune \\
        [--tune-bundle PATH] [--tune-buckets 64,256,1024] \\
        [--tune-kernels all|name,...] [--force]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --pod-smoke \\
        [--pod-processes 2] [--obs] [--shadow-rate F] [--device cpu]

``--smoke`` runs the reference's tiny train cell (2 layers, d 256, 16 /
8 heads of 16, vocab 1,024, batch 256 x 512 tokens) once on the
reference's 16 x 16 mesh: a group of 256 ranks that this one process
stands in for, through torch's ``fake`` backend, whose collectives move
nothing.  The mesh is on the card unless ``--device cpu`` asks for the
host.  Each op runs on rank 0's shards and every collective DTensor
issues is counted (:func:`~repro_torch.dist.hlo_analysis.
collective_stats`), so it checks layouts and collective accounting, not
numbers, as the reference's compile-only smoke does.  It exits non-zero
on a failed cell or on zero collective bytes.  :func:`run_cell` writes
each cell's record (status, per-kind collective counts and bytes, a
traceback on failure) as JSON under ``artifacts/dryrun_torch/``.
``--tune`` sweeps the fused MLP over a bundle's serving buckets (or the
two representative NAS widths), then every registered kernel's
representative problems, and writes the winners under
``artifacts/tune_torch/``; it needs a CUDA card.  ``--pod-smoke`` spawns
a real pod of ``--pod-processes`` processes (a gloo group, one rank a
process, on the card unless ``--device cpu``) and runs the cross-host
serve round-trip (:func:`repro_torch.launch.multihost.run_smoke`);
``--obs`` runs it with tracing on and writes the merged Chrome trace of
every host to ``artifacts/obs/pod_trace.json``, ``--shadow-rate``
shadow-scores that fraction of each host's requests (1.0 with
``--obs``).  The full cell matrix (``--all``,
``--arch``/``--shape``/``--multi-pod``) is ROADMAP item 10.6.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import time
import traceback

ARTIFACTS = (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
             / "dryrun_torch")
#: ranks of the reference's single-pod production mesh (16 x 16)
SMOKE_RANKS = 256


@contextlib.contextmanager
def fake_group(world: int):
    """A process group of ``world`` ranks that this process stands in
    for (rank 0), on torch's ``fake`` backend: collectives return at
    once and move nothing.  Destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _resident_bytes(args) -> int:
    """Bytes of this rank's blocks of every tensor of a cell."""
    from repro_torch.optim.adamw import tree_leaves
    total = 0
    for t in tree_leaves(args):
        if hasattr(t, "to_local"):
            t = t.to_local()
        if hasattr(t, "element_size"):
            total += t.numel() * t.element_size()
    return total


def run_cell(cfg, shape, outdir: pathlib.Path, *, force: bool = False,
             device=None) -> dict:
    """Run one cell's step (``cfg`` at ``shape``) once on the production
    mesh over the current group, on ``device`` (None: the card), under
    the collective recorder, and write its record; a cached record is
    returned unless ``force``."""
    from repro_torch.configs.base import cell_supported
    from repro_torch.dist.hlo_analysis import collective_stats
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import build_cell
    mesh_name = "pod16x16"
    outpath = pathlib.Path(outdir) / f"{cfg.name}__{shape.name}__" \
                                     f"{mesh_name}.json"
    if outpath.exists() and not force:
        return json.loads(outpath.read_text())
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name}
    ok, why = cell_supported(cfg, shape)
    if not ok:
        rec["status"] = why
    else:
        try:
            mesh = make_production_mesh(device=device)
            rec["mesh_shape"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
            rec["device"] = mesh.device_type
            t0 = time.time()
            with use_mesh(mesh):
                cell = build_cell(cfg, shape, mesh, device=mesh.device_type)
                rec["resident_per_rank_bytes"] = _resident_bytes(
                    cell["args"])
                with collective_stats() as st:
                    cell["fn"](*cell["args"])
            rec["run_s"] = round(time.time() - t0, 1)
            rec["coll_counts"] = dict(st.per_kind_count)
            rec["coll_bytes_per_kind"] = dict(st.per_kind_bytes)
            rec["coll_bytes"] = st.total_bytes
            rec["coll_bytes_corrected"] = st.corrected_bytes
            counts = cfg.param_counts()
            rec["params_total"] = counts["total"]
            rec["params_active"] = counts["active"]
            rec["status"] = "ok"
        except Exception as e:  # a failed cell is recorded, not raised
            rec["status"] = f"FAIL: {type(e).__name__}: {str(e)[:400]}"
            rec["traceback"] = traceback.format_exc()[-2000:]
    outpath.parent.mkdir(parents=True, exist_ok=True)
    outpath.write_text(json.dumps(rec, indent=1))
    return rec


def smoke_cell():
    """The reference's tiny train cell (``dryrun.py:205-209``)."""
    from repro_torch.configs.base import LayerSpec, ModelConfig, ShapeCell
    tiny = ModelConfig(name="smoke-tiny", n_layers=2, d_model=256,
                       n_heads=16, n_kv_heads=8, head_dim=16, d_ff=512,
                       vocab_size=1024, pattern=(LayerSpec(),))
    return tiny, ShapeCell("smoke_train", 512, 256, "train")


def run_smoke(outdir=ARTIFACTS, force: bool = False, device=None) -> dict:
    """The tiny sharded train cell on the 16 x 16 mesh of a fake group
    of 256 ranks (started here unless a group of that size is already
    up), on ``device`` (None: the card).  Must report non-zero
    collective bytes or it exits non-zero."""
    import torch.distributed as dist
    tiny, shape = smoke_cell()
    group = contextlib.nullcontext() if (
        dist.is_initialized() and dist.get_world_size() == SMOKE_RANKS) \
        else fake_group(SMOKE_RANKS)
    with group:
        rec = run_cell(tiny, shape, outdir, force=force, device=device)
    coll = rec.get("coll_bytes", 0)
    print(f"[smoke] status={rec.get('status')} device={rec.get('device')} "
          f"run={rec.get('run_s', 0)}s "
          f"coll_bytes/rank={coll:.3e} counts={rec.get('coll_counts')} "
          f"bytes={rec.get('coll_bytes_per_kind')}", flush=True)
    if rec.get("status") != "ok" or not coll:
        raise SystemExit(f"smoke cell failed: {rec.get('status')} "
                         f"coll_bytes={coll}")
    return rec


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
        description="the port's sharded dry run and deploy-time kernel "
                    "tuning")
    ap.add_argument("--smoke", action="store_true",
                    help="run the tiny sharded train cell on a fake "
                         "256-rank group; non-zero exit unless it runs "
                         "with non-zero collective bytes")
    ap.add_argument("--pod-smoke", action="store_true",
                    help="spawn a real pod (a gloo group of processes) "
                         "and run the cross-host serve round-trip")
    ap.add_argument("--pod-processes", type=int, default=2)
    ap.add_argument("--obs", action="store_true",
                    help="with --pod-smoke: run the pod with tracing on, "
                         "all-gather every host's spans/metrics "
                         "(obs.pod_snapshot) and write the merged Chrome "
                         "trace to artifacts/obs/pod_trace.json")
    ap.add_argument("--shadow-rate", type=float, default=None,
                    help="with --pod-smoke: shadow-score this fraction of "
                         "served requests per host (default 1.0 with "
                         "--obs) and report cross-host drift state")
    ap.add_argument("--tune", action="store_true",
                    help="sweep the kernels and persist the winners")
    ap.add_argument("--force", action="store_true",
                    help="redo cells or re-sweep problems that already "
                         "have a record")
    ap.add_argument("--out", default=str(ARTIFACTS),
                    help="--smoke: directory of the cell records")
    ap.add_argument("--device", default=None,
                    help="--smoke/--pod-smoke: the device type of the mesh "
                         "(default: cuda; cpu runs it on the host)")
    ap.add_argument("--tune-bundle", default=None,
                    help="--tune: autotune this bundle's widths instead of "
                         "the representative NAS widths")
    ap.add_argument("--tune-buckets", default="64,256,1024",
                    help="--tune: comma-separated batch buckets to sweep")
    ap.add_argument("--tune-kernels", default="all",
                    help="--tune: comma-separated registered kernels to "
                         "sweep, or 'all'")
    args = ap.parse_args(argv)
    if args.pod_smoke:
        from repro_torch.launch.multihost import run_smoke as run_pod_smoke
        obs_out = None
        if args.obs:
            obs_out = str(ARTIFACTS.parent / "obs" / "pod_trace.json")
        run_pod_smoke(processes=args.pod_processes, obs_out=obs_out,
                      shadow_rate=args.shadow_rate, device=args.device)
        return
    if args.obs:
        ap.error("--obs needs --pod-smoke (the flight recorder is a pod "
                 "collective)")
    if args.smoke:
        run_smoke(pathlib.Path(args.out), force=args.force,
                  device=args.device)
        return
    if not args.tune:
        ap.error("pass --smoke, --pod-smoke or --tune")
    run_tune(args.tune_bundle,
             [int(b) for b in args.tune_buckets.split(",")],
             force=args.force, kernels=args.tune_kernels)


if __name__ == "__main__":
    main()
