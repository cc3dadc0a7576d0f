"""The port stands alone: repro_torch and chip_smoke.py import neither
JAX nor the JAX package."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)"
    r"|from\s+repro(\.|\s)(?!_torch))", re.M)


def test_port_imports_with_jax_and_repro_blocked():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke\n"
        "assert {'repro_torch.core.engine', 'repro_torch.launch.dryrun',\n"
        "        'repro_torch.tune.kernel_tuner', 'repro_torch.serve.queue',\n"
        "        'repro_torch.kernels.stencil_gather.ops',\n"
        "        'repro_torch.kernels.flash_attention.int8',\n"
        "        'repro_torch.kernels.rwkv6_chunk.ops',\n"
        "        'repro_torch.kernels.mamba_scan.ops',\n"
        "        'repro_torch.kernels.mamba_scan.mamba_scan',\n"
        "        'repro_torch.kernels.mamba_scan.ref',\n"
        "        'repro_torch.models.lm', 'repro_torch.launch.serve_lm',\n"
        "        'repro_torch.models.rope', 'repro_torch.models.attention',\n"
        "        'repro_torch.examples.serve_lm',\n"
        "        'repro_torch.nas.nested', 'repro_torch.nas.train_surrogate',\n"
        "        'repro_torch.apps.miniweather',\n"
        "        'repro_torch.apps.particlefilter',\n"
        "        'repro_torch.examples.quickstart',\n"
        "        'repro_torch.obs.trace', 'repro_torch.obs.quality',\n"
        "        'repro_torch.obs.slo', 'repro_torch.resilience.faults',\n"
        "        'repro_torch.resilience.retry',\n"
        "        'repro_torch.resilience.breaker',\n"
        "        'repro_torch.serve.stats', 'repro_torch.serve.scratch',\n"
        "        'repro_torch.serve.batcher', 'repro_torch.serve.residency',\n"
        "        'repro_torch.serve.tenancy',\n"
        "        'repro_torch.dist.hlo_analysis',\n"
        "        'repro_torch.tune.controller', 'repro_torch.tune.resweep',\n"
        "        'repro_torch.obs.server', 'repro_torch.obs.metrics_report',\n"
        "        'repro_torch.obs.pod',\n"
        "        'repro_torch.models.loss', 'repro_torch.optim.adamw',\n"
        "        'repro_torch.train.trainer',\n"
        "        'repro_torch.train.compression',\n"
        "        'repro_torch.data.pipeline', 'repro_torch.ckpt.checkpoint',\n"
        "        'repro_torch.examples.train_lm',\n"
        "        'repro_torch.kernels.flash_attention.flash_attention'\n"
        "        } <= set(names)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120, cwd=str(ROOT))


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_import_statement(path):
    assert not _FORBIDDEN.findall(path.read_text()), path


def test_scan_catches_forbidden_imports():
    for bad in ("import jax", "from jax import numpy", "import repro.core",
                "from repro.nn import layers", "    from repro import x"):
        assert _FORBIDDEN.search(bad), bad
    for good in ("import repro_torch", "from repro_torch.nn import MLP",
                 "import jaxlib_free_module"):
        assert not _FORBIDDEN.search(good), good
