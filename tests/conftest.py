import os
import sys
import pathlib

# tests run on the single real CPU device (the 512-device forcing is
# exclusively dryrun.py's); keep XLA quiet and deterministic.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)
if str(ROOT / "tests") not in sys.path:
    sys.path.insert(0, str(ROOT / "tests"))

def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: spawns real multi-process jax pods (the multihost CI lane "
        "runs these; deselect with -m 'not slow' for quick iteration)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card and nvcc (launches a hand-written kernel "
        "of repro_torch); skips itself where there is none")


try:  # offline image has no hypothesis wheel; shim keeps the suite runnable
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import _hypothesis_shim
    sys.modules["hypothesis"] = _hypothesis_shim
    sys.modules["hypothesis.strategies"] = _hypothesis_shim.strategies
