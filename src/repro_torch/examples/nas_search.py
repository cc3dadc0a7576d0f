"""Standalone nested-BO surrogate search (paper §V-C) for any benchmark,
on the port (twin of ``examples/nas_search.py``).

Run:  PYTHONPATH=src python -m repro_torch.examples.nas_search --app binomial --n 2048 [--device cpu]
"""
import argparse
import pathlib
import tempfile

from repro_torch.apps import ALL_APPS
from repro_torch.nas.nested import best_trial, nested_search, save_trial


def collect(app_name, app, n, db_path, device=None):
    """Run ``app``'s region in collect mode over ``n`` rows (steps for
    miniweather, frames for particlefilter) into a SurrogateDB."""
    if app_name == "miniweather":
        region = app.make_region(mode="collect", database=db_path,
                                 device=device)
        s = app.init_state(device=device)
        for _ in range(n):
            s = region(state=s)["state"]
    elif app_name == "particlefilter":
        frames, _ = app.make_video(n, device=device)
        region = app.make_region(n, mode="collect", database=db_path,
                                 device=device)
        region(frames=frames.reshape(n, -1))
    else:
        x = app.make_inputs(n, device=device)
        region = app.make_region(n, mode="collect", database=db_path,
                                 device=device)
        key = next(iter(region.inputs))
        region(**{key: x})
    region.db.flush()
    return region.db


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--app", default="binomial", choices=list(ALL_APPS))
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--outer", type=int, default=8)
    ap.add_argument("--inner", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    app = ALL_APPS[args.app]
    tmp = pathlib.Path(args.out or tempfile.mkdtemp())
    db = collect(args.app, app, args.n, str(tmp / "db"), args.device)
    res = nested_search(app, db.group(args.app), outer_iters=args.outer,
                        inner_iters=args.inner, device=args.device)
    print(f"\nexplored {len(res['trials'])} architectures; Pareto front:")
    for i in res["pareto"]:
        t = res["trials"][i]
        print(f"  {t['arch']}  rmse={t['val_rmse']:.5f} "
              f"lat={t['latency']*1e3:.2f}ms")
    mp = save_trial(best_trial(res), tmp / "model")
    print(f"best model saved to {mp}")


if __name__ == "__main__":
    main()
