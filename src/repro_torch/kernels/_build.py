"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` under ``repro_torch/kernels`` exposes a plain C
interface, so it compiles on its own in seconds into a shared library
(no PyTorch headers)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <src>

Shared device code lives in headers (``kernels/csrc/*.cuh``) that a source
includes by a quoted path relative to itself.  The library lands under
``build/kernels/`` at the root of the checkout at first use, named by a
hash of its source, the headers it includes (transitively) and the flags,
so an edited source or header is rebuilt and an unchanged one is loaded
as it is.  ``nvcc`` is looked up only when a kernel is first needed: the
package imports on machines without the CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List

KERNELS_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class Built:
    """One compiled kernel library and what its build reported."""
    name: str
    source: pathlib.Path
    so_path: pathlib.Path
    seconds: float        # 0.0 when an up-to-date library was reused
    ptxas: str            # nvcc's -Xptxas -v report (registers, smem, spills)
    lib: ctypes.CDLL = dataclasses.field(repr=False)


_lock = threading.Lock()
_built: Dict[str, Built] = {}


def sources() -> Dict[str, pathlib.Path]:
    """Every kernel source in the port, by stem name."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``.  Raises when the toolkit is absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels need the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def includes(src: pathlib.Path) -> List[pathlib.Path]:
    """The headers ``src`` includes by quoted path, transitively, each
    resolved against the directory of the file that includes it."""
    found: List[pathlib.Path] = []
    todo = [src]
    while todo:
        path = todo.pop()
        for name in _INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / name.decode()).resolve()
            if dep.exists() and dep not in found and dep != src:
                found.append(dep)
                todo.append(dep)
    return found


def _target(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for dep in includes(src):
        h.update(dep.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _start(compiler: str, src: pathlib.Path, so: pathlib.Path):
    """Start one nvcc into a temporary name; returns (process, tmp path)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.Popen([compiler, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp


def build_all(names: List[str] | None = None) -> Dict[str, Built]:
    """Build (or reuse) the named kernels, all nvcc processes started
    together, and load them.  Raises if any build fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    with _lock:
        missing = [n for n in names if n not in srcs]
        if missing:
            raise KeyError(f"no kernel source for {missing}; have "
                           f"{sorted(srcs)}")
        targets = {n: _target(srcs[n]) for n in names if n not in _built}
        compiler = nvcc() if any(not so.exists()
                                 for so in targets.values()) else ""
        todo = {n: (srcs[n], so,
                    None if so.exists() else _start(compiler, srcs[n], so))
                for n, so in targets.items()}
        t0 = time.perf_counter()
        errors = []
        for name, (src, so, job) in todo.items():
            report = ""
            if job is not None:
                proc, tmp = job
                report, _ = proc.communicate()
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    errors.append(f"nvcc failed for {src} "
                                  f"(rc {proc.returncode}):\n{report}")
                    continue
                os.replace(tmp, so)  # atomic: concurrent builds agree
            _built[name] = Built(
                name, src, so,
                time.perf_counter() - t0 if job is not None else 0.0,
                report, ctypes.CDLL(str(so)))
        if errors:
            raise RuntimeError("\n".join(errors))
        return {n: _built[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    built = _built.get(name)
    if built is None:
        built = build_all([name])[name]
    return built.lib
