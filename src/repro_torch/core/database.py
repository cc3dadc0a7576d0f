"""SurrogateDB: the data-collection store (paper §IV-B).

HDF5 is unavailable offline, so the store is an npz-chunk directory that
keeps HDF5's group/dataset semantics: one *group* per annotated region,
holding three datasets — ``inputs`` (bridged input tensors), ``outputs``
(bridged output tensors) and ``runtime`` (wall time of the accurate path
per invocation, used by the NAS stage to price performance/accuracy
trade-offs without re-running the application).

Layout:
    <root>/<region>/meta.json
    <root>/<region>/chunk_00000.npz   (inputs, outputs, runtime arrays)
"""
from __future__ import annotations

import atexit
import json
import pathlib
import threading
import weakref

import numpy as np

# collect-mode rows buffered below chunk_rows must never be lost to process
# exit: every live store flushes at interpreter shutdown
_LIVE_STORES: "weakref.WeakSet[RegionStore]" = weakref.WeakSet()


@atexit.register
def _flush_all_at_exit():
    for store in list(_LIVE_STORES):
        try:
            store.flush()
        except Exception:
            pass  # shutdown best-effort; a partial flush must not mask exit


class RegionStore:
    def __init__(self, root: pathlib.Path, name: str, chunk_rows: int = 4096):
        self.dir = root / name
        self.dir.mkdir(parents=True, exist_ok=True)
        self.name = name
        self.chunk_rows = chunk_rows
        self._buf_in, self._buf_out, self._buf_rt = [], [], []
        self._lock = threading.Lock()
        _LIVE_STORES.add(self)

    # -------------------------------------------------------- writing -----
    def append(self, inputs, outputs, runtime: float):
        """Append one invocation's bridged tensors (leading dim = batch)."""
        with self._lock:
            self._buf_in.append(np.asarray(inputs))
            self._buf_out.append(np.asarray(outputs))
            self._buf_rt.append(float(runtime))
            if sum(x.shape[0] for x in self._buf_in) >= self.chunk_rows:
                self._flush_locked()

    def flush(self):
        with self._lock:
            if self._buf_in:
                self._flush_locked()

    def _flush_locked(self):
        existing = sorted(self.dir.glob("chunk_*.npz"))
        idx = len(existing)
        inputs = np.concatenate(self._buf_in, axis=0)
        outputs = np.concatenate(self._buf_out, axis=0)
        in_shape, out_shape = list(inputs.shape[1:]), list(outputs.shape[1:])

        # meta.json describes the FULL store, not just the last flush
        meta_path = self.dir / "meta.json"
        prior = json.loads(meta_path.read_text()) if meta_path.exists() \
            else None
        if prior is not None:
            # schema drift is refused BEFORE anything touches disk: the
            # mismatched buffer is dropped so retries (and the atexit
            # flush) cannot corrupt or duplicate the store
            for key, shape in (("input_shape", in_shape),
                               ("output_shape", out_shape)):
                if prior.get(key) is not None and prior[key] != shape:
                    self._buf_in, self._buf_out, self._buf_rt = [], [], []
                    raise ValueError(
                        f"region {self.name!r}: {key} changed from "
                        f"{prior[key]} to {shape}; refusing to mix schemas")
        rows = int(inputs.shape[0])
        if prior is not None and "rows" in prior:
            rows += int(prior["rows"])
        else:  # legacy store without row accounting: scan once
            for c in existing:
                with np.load(c) as z:
                    rows += int(z["inputs"].shape[0])

        np.savez(
            self.dir / f"chunk_{idx:05d}.npz",
            inputs=inputs,
            outputs=outputs,
            runtime=np.asarray(self._buf_rt, np.float64),
        )
        meta = {"region": self.name, "chunks": idx + 1, "rows": rows,
                "input_shape": in_shape, "output_shape": out_shape}
        meta_path.write_text(json.dumps(meta))
        self._buf_in, self._buf_out, self._buf_rt = [], [], []

    # -------------------------------------------------------- reading -----
    def load(self):
        """Returns dict(inputs, outputs, runtime) stacked over all chunks."""
        self.flush()
        chunks = sorted(self.dir.glob("chunk_*.npz"))
        if not chunks:
            raise FileNotFoundError(f"no data collected for region "
                                    f"{self.name!r} in {self.dir}")
        ins, outs, rts = [], [], []
        for c in chunks:
            z = np.load(c)
            ins.append(z["inputs"])
            outs.append(z["outputs"])
            rts.append(z["runtime"])
        return {"inputs": np.concatenate(ins), "outputs": np.concatenate(outs),
                "runtime": np.concatenate(rts)}

    def train_test_split(self, test_frac=0.2, seed=0):
        d = self.load()
        n = d["inputs"].shape[0]
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n)
        cut = int(n * (1 - test_frac))
        tr, te = perm[:cut], perm[cut:]
        return ({"inputs": d["inputs"][tr], "outputs": d["outputs"][tr]},
                {"inputs": d["inputs"][te], "outputs": d["outputs"][te]})


class SurrogateDB:
    def __init__(self, path):
        self.root = pathlib.Path(path)
        self.root.mkdir(parents=True, exist_ok=True)
        self._groups = {}

    def group(self, name: str) -> RegionStore:
        if name not in self._groups:
            self._groups[name] = RegionStore(self.root, name)
        return self._groups[name]

    def groups(self):
        return [p.name for p in self.root.iterdir() if p.is_dir()]

    def flush(self):
        for g in self._groups.values():
            g.flush()
