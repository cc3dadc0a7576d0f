"""MiniWeather surrogate campaign on the port: the paper's Observation-4
experiment (twin of ``examples/surrogate_miniweather.py``).

collect -> nested BO search -> deploy -> interleave accurate/surrogate
timesteps and measure error propagation (paper Fig. 9).

Run:  PYTHONPATH=src python -m repro_torch.examples.surrogate_miniweather [--device cpu]
"""
import argparse
import pathlib
import tempfile

from repro_torch.apps import miniweather as mw
from repro_torch.nas.nested import best_trial, nested_search, save_trial


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = args.device
    tmp = pathlib.Path(tempfile.mkdtemp())
    state = mw.init_state(device=dev)

    # 1) data collection over a training trajectory (paper: first 1000 steps)
    region = mw.make_region(mode="collect", database=str(tmp / "db"),
                            device=dev)
    s = state
    for _ in range(120):
        s = region(state=s)["state"]
    region.db.flush()

    # 2) nested BO search (reduced budget)
    res = nested_search(mw, region.db.group("miniweather"),
                        outer_iters=5, inner_iters=2, epochs=20, device=dev)
    bt = best_trial(res)
    mp = save_trial(bt, tmp / "model")
    print(f"best surrogate: {bt['arch']} val_rmse={bt['val_rmse']:.5f}")

    # 3) interleave configurations (paper Fig. 9d)
    region2 = mw.make_region(mode="predicated", model=str(mp), device=dev)
    horizon = 40
    ref = mw.run(state, horizon)
    for (na, ns) in [(1, 0), (1, 1), (1, 3), (0, 1)]:
        approx = mw.run(state, horizon, region=region2, interleave=(na, ns))
        err = mw.qoi_error(ref, approx)
        print(f"  interleave accurate:surrogate = {na}:{ns:<2d} "
              f"RMSE@{horizon} = {err:.5f}")


if __name__ == "__main__":
    main()
