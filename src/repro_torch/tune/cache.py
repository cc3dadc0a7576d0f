"""On-disk tune cache, kernel-namespaced (counterpart of
``repro/tune/cache.py``).

One JSON file per namespace under ``artifacts/tune_torch/`` (the port's
own directory: it never writes the reference's ``artifacts/tune/``),
schema 2:

    {"schema": 2, "kernel": "<name>", "entries": {key: record}}

A record carries ``params`` and ``exact``; only records with
``exact=True`` resolve through :func:`best_params`.  The quant gate's
verdicts live here too (namespace ``quant_gate``).

Reads are memoized and refreshed when the file's ``(mtime_ns, size)``
changes; writes are atomic (tmp + rename), so a crashed writer never
leaves a torn file and concurrent writers merge.  The reference migrates
legacy schema-1 files; the port never wrote schema 1, so that migration
is dropped and any file that is not schema 2 reads as empty.  The sweep
that fills the caches is :mod:`repro_torch.tune.kernel_tuner`.
"""
from __future__ import annotations

import json
import os
import pathlib
import tempfile
import threading
from typing import Dict, Iterable, Optional, Sequence

from repro_torch.obs import metrics as _m

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "tune_torch"

SCHEMA = 2


def _dtype_name(dtype) -> str:
    """Canonical dtype spelling: ``torch.float32`` and ``"float32"`` key
    alike."""
    return str(dtype).removeprefix("torch.")


def shape_key(widths: Iterable[int], dtype, backend: str, bucket: int) -> str:
    """The fused-MLP cache key ``"<w0-w1-...>|<dtype>|<backend>|b<bucket>"``,
    the reference's format."""
    w = "-".join(str(int(v)) for v in widths)
    return f"{w}|{_dtype_name(dtype)}|{backend}|b{int(bucket)}"


class TuneCache:
    """Persistent measured-config store for one namespace."""

    def __init__(self, kernel: str = "fused_mlp", path=None):
        self.kernel = kernel
        self.path = pathlib.Path(path) if path is not None else (
            ART / f"{kernel}.json")
        self._lock = threading.Lock()
        self._mem: Dict[str, dict] = {}
        self._fingerprint = None  # (mtime_ns, size) of the last read

    def _file_fingerprint(self):
        try:
            st = os.stat(self.path)
            return (st.st_mtime_ns, st.st_size)
        except OSError:
            return None

    def _refresh_locked(self) -> None:
        fp = self._file_fingerprint()
        if fp == self._fingerprint:
            return
        self._fingerprint = fp
        self._mem = {}
        if fp is None:
            return
        try:
            data = json.loads(self.path.read_text())
        except (OSError, ValueError):
            return  # a torn/corrupt cache is a cache miss, never a crash
        if isinstance(data, dict) and data.get("schema") == SCHEMA \
                and isinstance(data.get("entries"), dict):
            self._mem = data["entries"]

    def _save_locked(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                   prefix=self.path.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"schema": SCHEMA, "kernel": self.kernel,
                           "entries": self._mem}, f, indent=1,
                          sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._fingerprint = self._file_fingerprint()

    def get(self, key: str) -> Optional[dict]:
        """Record for a key, or None."""
        with self._lock:
            self._refresh_locked()
            return self._mem.get(key)

    def put(self, key: str, record: dict) -> None:
        with self._lock:
            self._refresh_locked()  # merge with concurrent writers' entries
            self._mem[key] = record
            self._save_locked()

    def entries(self) -> Dict[str, dict]:
        with self._lock:
            self._refresh_locked()
            return dict(self._mem)


# process-wide default caches, one per namespace
_default: Dict[str, TuneCache] = {}
_default_lock = threading.Lock()


def default_cache(kernel: str = "fused_mlp") -> TuneCache:
    with _default_lock:
        c = _default.get(kernel)
        if c is None:
            c = _default[kernel] = TuneCache(kernel)
        return c


def _record_params(rec: Optional[dict]) -> Optional[Dict[str, int]]:
    """Validated winner params of a record, or None: a record that is
    not ``exact`` never resolves."""
    if rec is None or not rec.get("exact", False):
        return None
    params = rec.get("params")
    if not isinstance(params, dict) or not params:
        return None
    try:
        return {k: int(v) for k, v in params.items()}
    except (TypeError, ValueError):
        return None


def best_params(kernel: str, keys: Sequence[str]) -> Optional[Dict[str, int]]:
    """First validated winner along ``keys`` (ordered lookup fallbacks),
    or None.  Hits and misses are counted in
    ``repro_tune_cache_lookups_total``; a missed chain's leading key in
    ``repro_tune_cache_miss_keys_total``."""
    cache = default_cache(kernel)
    lookups = _m.counter("repro_tune_cache_lookups_total",
                         "tune-cache lookups by outcome",
                         ("kernel", "outcome"))
    for key in keys:
        params = _record_params(cache.get(key))
        if params is not None:
            lookups.inc(1, kernel=kernel, outcome="hit")
            return params
    lookups.inc(1, kernel=kernel, outcome="miss")
    if keys:
        _m.counter("repro_tune_cache_miss_keys_total",
                   "tune-cache lookup chains that missed, by leading key",
                   ("kernel", "key")).inc(1, kernel=kernel, key=keys[0])
    return None


def best_tile(widths, dtype, backend: str, batch: int) -> Optional[int]:
    """Tuned ``block_rows`` for a fused-MLP call, or None when untuned.

    The lookup is the fused MLP spec's own (``mlp_cache_keys``): the
    exact batch first, then its power-of-two bucket.
    """
    from repro_torch.kernels.fused_mlp.ops import SPEC
    problem = {"widths": widths, "dtype": _dtype_name(dtype),
               "batch": int(batch)}
    rows = (best_params(SPEC.name, SPEC.lookup_keys(problem, backend))
            or {}).get("block_rows")
    return int(rows) if rows and rows > 0 else None
