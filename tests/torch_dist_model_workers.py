"""The port's side of ``tests/test_torch_dist_models.py``, importable
without JAX (the spawned ranks stay light): each family's prefill, decode
steps and training step on one rank (no mesh) or on a gloo group's data 2
x model 2 mesh, through the step functions of its cells
(``launch.specs.build_cell``), every result gathered whole into numpy.

:func:`run_family` returns ``(arrays, meta)``: ``arrays`` maps
``"<phase>/<what>"`` to f32 numpy arrays (``prefill``, the prompt's
logits and caches; ``decode`` at batch 2 with a ``"kvseq"`` cache,
``decode_long`` at batch 1 with the cache laid out on ``"longseq"``;
``train``'s loss and every gradient, ``train_step``'s loss and norm),
``meta`` what the sharded run reports about itself (placements,
collectives, plain-version calls, the MoE adjoint's backward calls).
:func:`worker_main` is one rank of the group.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import pickle
import sys
import time
from unittest import mock

import numpy as np
import torch

from repro_torch.configs import archs, base
from repro_torch.configs.base import ShapeCell
from repro_torch.ckpt.checkpoint import leaf_paths
from repro_torch.dist.hlo_analysis import collective_stats
from repro_torch.dist.sharding import (full_tensor, is_dtensor,
                                       param_shardings, use_mesh)
from repro_torch.kernels import registry
from repro_torch.launch.specs import build_cell
from repro_torch.models import blocks, lm
from repro_torch.optim.adamw import init_opt_state, tree_leaves, tree_map
from repro_torch.train import trainer

# every registered family (qwen1.5 is llama's layer with biases, which
# qwen2-vl carries), then two variants of llama: an int8 KV cache
# (serving only), and one kv head, which the model axis cannot split (K
# and V whole on it, their gradients partial sums over it)
FAMILIES = ("llama3.2-3b", "qwen3-4b", "qwen2-vl-7b", "whisper-medium",
            "rwkv6-1.6b", "deepseek-v2-lite-16b", "jamba-v0.1-52b",
            "grok-1-314b")
VARIANTS = ("llama3.2-3b:int8", "llama3.2-3b:kv1")
SERVE_ONLY = ("llama3.2-3b:int8",)
MESH = (2, 2)
B, S, CACHE = 2, 8, 12      # batch, prompt, cache positions
KERNELS = ("flash_attention", "mamba_scan", "rwkv6_chunk")


def cut(cfg, name):
    """The reduced config of ``name`` (``arch``, or ``arch:int8`` /
    ``arch:kv1`` for the variants) in f32 (either package's), at one
    repeat of its pattern (each layer starts from the residual stream's
    site, so a second adds nothing the mesh would see); jamba at slots
    3-5 of its period (Mamba, attention + MoE, Mamba), as
    ``chip_smoke.py`` serves it."""
    arch, _, variant = name.partition(":")
    if arch.startswith("jamba"):
        cfg = cfg.replace(pattern=cfg.pattern[3:6])
    kw = {"dtype": "float32", "n_layers": len(cfg.prefix) + len(cfg.pattern)}
    if cfg.enc_dec:
        kw["enc_layers"] = len(cfg.enc_pattern)
    if variant == "int8":
        kw["kv_cache_dtype"] = "int8"
    elif variant == "kv1":
        kw["n_kv_heads"] = 1
    return cfg.replace(**kw)


def config(name):
    return cut(archs.reduced(base.get_config(name.partition(":")[0])),
               name)


def inputs(cfg, seed=1) -> dict:
    """Seeded numpy inputs: ``tokens`` ``[B, S + 1]`` (the prompt, then
    the decoded token; for training, inputs and targets one apart),
    mrope ``position_ids`` ``[3, B, S]`` and an encoder-decoder model's
    ``enc_embeds`` ``[B, enc_ctx, d]``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1))}
    if cfg.needs_position_ids:
        out["position_ids"] = np.stack(
            [np.arange(S)[None].repeat(B, 0) + d for d in (0, 3, 5)])
    if cfg.enc_dec:
        out["enc_embeds"] = rng.standard_normal(
            (B, cfg.enc_ctx, cfg.d_model)).astype(np.float32)
    return out


def _np(t):
    """A copy (a cache is written in place after it is saved)."""
    return full_tensor(t).detach().to(torch.float32).numpy().copy()


def _save(out, phase, logits, caches):
    out[f"{phase}/logits"] = _np(logits)
    for key, t in zip(leaf_paths(caches), tree_leaves(caches)):
        out[f"{phase}/cache/{key}"] = _np(t)


def _prompt(inp, rows, ctx):
    """The prompt's tensors for batch ``rows`` (the prefill cell's
    batch), laid out on the mesh, and the decoded token."""
    lay = (lambda t, axes: t) if ctx is None else ctx.make_global
    kw = {"tokens": lay(torch.from_numpy(inp["tokens"][rows, :S]),
                        ("batch", None))}
    if "position_ids" in inp:
        kw["position_ids"] = lay(torch.from_numpy(
            inp["position_ids"][:, rows]), (None, "batch", None))
    if "enc_embeds" in inp:
        kw["enc_embeds"] = lay(torch.from_numpy(inp["enc_embeds"][rows]),
                               ("batch", None, None))
    nxt = lay(torch.from_numpy(inp["tokens"][rows, S:]), ("batch", None))
    return kw, nxt


def _params(cfg, tree, mesh, grad):
    p = lm.params_from_jax(cfg, tree, device="cpu")
    for t in tree_leaves(p):
        t.requires_grad_(grad)
    if mesh is None:
        return p
    return trainer.shard_state(p, param_shardings(p, cfg, mesh))


def _kv_leaf(caches):
    """The first attention cache leaf (K, or MLA's latent), or None."""
    for key, t in zip(leaf_paths(caches), tree_leaves(caches)):
        if key.endswith(("mixer/k", "mixer/ckv")):
            return t
    return None


def _cells(cfg, mesh):
    """The step functions of the family's cells (``build_cell``): the
    prefill, the decode step at ``long_ctx`` False and True (derived
    from the shape's name, as the reference derives it) and the train
    step.  The cells' own seeded tensors are not used."""
    cells = {"prefill": ShapeCell("prefill_x", S, B, "prefill"),
             "decode": ShapeCell("decode_x", CACHE, B, "decode"),
             "decode_long": ShapeCell("long_x", CACHE, 1, "decode"),
             "train": ShapeCell("train_x", S, B, "train")}
    return {k: build_cell(cfg, shape, mesh, device="cpu")["fn"]
            for k, shape in cells.items()}


def _where(mesh):
    return use_mesh(mesh) if mesh is not None else contextlib.nullcontext()


def run_family(name, tree, inp, mesh=None):
    """One family's serving and training on one rank (``mesh`` None) or
    under ``mesh``, through its cells' step functions (``build_cell``):
    the prefill cell on the prompt; a prefill into a cache of ``CACHE``
    positions, then the decode cell at position ``S``; row 0 of that
    cache laid out with ``long_ctx``, then the long decode cell; the
    train cell's step, its loss and every gradient kept as its
    ``compute_grads`` returns them (before the clip scales them in
    place).  See the module docstring."""
    cfg = config(name)
    out, meta = {}, {"collectives": {}, "cache_placements": {},
                     "seconds": {}}
    t0 = time.perf_counter()
    calls = {k: registry.get_spec(k).plain_calls for k in KERNELS}
    params = _params(cfg, tree, mesh, False)
    with _where(mesh) as ctx, torch.no_grad():
        fns = _cells(cfg, mesh)
        kw, nxt = _prompt(inp, slice(None), ctx)
        _save(out, "prefill", *fns["prefill"](params, kw))
        tokens = kw.pop("tokens")
        logits, caches = lm.prefill(cfg, params, tokens, cache_len=CACHE,
                                    **kw)
        # row 0's cache, copied before the step writes into the batch's
        row0 = lm.lay_out_caches(cfg, tree_map(
            lambda t: t[:1].clone(), caches), long_ctx=True)
        for phase, c, tok in (("decode", caches, nxt),
                              ("decode_long", row0, nxt[:1])):
            kv = _kv_leaf(c)
            if mesh is not None and kv is not None:
                meta["cache_placements"][phase] = repr(kv.placements)
            with (collective_stats() if mesh is not None
                  else contextlib.nullcontext()) as stats:
                _save(out, phase, *fns[phase](params, c, {"tokens": tok}, S))
            if stats is not None:
                meta["collectives"][phase] = stats.per_kind_bytes
    meta["seconds"]["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if name not in SERVE_ONLY:
        params = _params(cfg, tree, mesh, True)
        with _where(mesh) as ctx:
            lay = (lambda t, axes: t) if ctx is None else ctx.make_global
            toks = torch.from_numpy(inp["tokens"])
            batch = {"tokens": lay(toks[:, :S], ("batch", None)),
                     "targets": lay(toks[:, 1:], ("batch", None))}
            if "position_ids" in inp:
                batch["position_ids"] = lay(torch.from_numpy(
                    inp["position_ids"]), (None, "batch", None))
            if "enc_embeds" in inp:
                batch["enc_embeds"] = lay(torch.from_numpy(
                    inp["enc_embeds"]), ("batch", None, None))
            state = {"params": params,
                     "opt": init_opt_state(params, cfg.opt_policy)}
            grads_of = trainer.compute_grads

            def kept(*args, **kw):  # the step's loss and gradients, saved
                loss, grads = grads_of(*args, **kw)  # before the clip
                out["train/loss"] = _np(loss)
                for key, g in zip(leaf_paths(grads), tree_leaves(grads)):
                    out[f"train/grad/{key}"] = _np(g)
                return loss, grads
            with mock.patch.object(trainer, "compute_grads", kept):
                _, metrics = fns["train"](state, batch)
            for k in ("loss", "grad_norm"):
                out[f"train_step/{k}"] = _np(metrics[k])
        meta["seconds"]["train"] = time.perf_counter() - t0
    meta["plain_calls"] = {k: registry.get_spec(k).plain_calls - calls[k]
                           for k in KERNELS}
    return out, meta


def _counting(fn, counts, key):
    def wrapped(*args, **kw):
        counts[key] = counts.get(key, 0) + 1
        return fn(*args, **kw)
    return wrapped


def _wait_for(path, timeout=240.0):
    """The object pickled at ``path`` once it appears (the test's
    processes write the weights while the ranks run)."""
    t0 = time.monotonic()
    while not path.exists():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


def worker_main(argv):
    """One rank: ``RANK WORLD PORT TMP``.  Runs every family of
    ``TMP/names.json`` from ``TMP/<i>.pkl`` (the reference's weights and
    the inputs, waited for) under the data 2 x model 2 mesh; rank 0 writes
    ``TMP/<i>.npz``, every rank ``TMP/<i>.rank<r>.json``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    rank, world, port, tmp = (int(argv[0]), int(argv[1]), argv[2],
                              pathlib.Path(argv[3]))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    seen = {}
    dispatch = registry.dispatch

    def checked(spec, problem, arrays, device, **kw):
        if any(is_dtensor(a) for a in arrays):
            seen["dtensor_dispatches"] = seen.get("dtensor_dispatches",
                                                  0) + 1
        return dispatch(spec, problem, arrays, device, **kw)
    registry.dispatch = checked
    for cls in (blocks._DispatchScatter, blocks._CombineGather):
        cls.backward = staticmethod(_counting(cls.backward, seen,
                                              cls.__name__))
    try:
        mesh = make_local_mesh(MESH, device="cpu")
        for i, name in enumerate(json.loads((tmp / "names.json")
                                            .read_text())):
            tree, inp = _wait_for(tmp / f"{i}.pkl")
            seen.clear()
            arrays, meta = run_family(name, tree, inp, mesh)
            meta.update(seen)
            if rank == 0:
                np.savez(tmp / f"{i}.npz", **arrays)
            (tmp / f"{i}.rank{rank}.json").write_text(json.dumps(meta))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    worker_main(sys.argv[1:])
