"""Per-cell inputs and step builders (counterpart of
``repro/launch/specs.py``).

``input_specs(cfg, shape)`` gives each model input of a cell as a
:class:`InputSpec`: its shape, dtype and resolved spec on the mesh (the
reference's ``ShapeDtypeStruct`` with a sharding).  Torch has no
abstract trace to lower, so :func:`build_cell` makes the cell's tensors:
seeded inputs, parameters (or a train state) and caches, each a DTensor
laid out on the mesh by the reference's rules, beside the step that
runs them.  Modality frontends are stubs, as in the reference: whisper
gets frame embeddings ``[B, enc_ctx, d_model]``, qwen2-vl 3-component
M-RoPE position ids beside its tokens.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import (ShardCtx, distribute,
                                       param_spec_tree, placements_for)
from repro_torch.models import lm
from repro_torch.optim.adamw import tree_map
from repro_torch.train import trainer


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """One input of a cell: global shape, dtype and spec on the mesh."""

    shape: tuple
    dtype: torch.dtype
    spec: tuple


def input_specs(cfg: ModelConfig, shape: ShapeCell, mesh=None,
                multi_pod: bool = False) -> dict:
    """Batch inputs of one cell (no params, no caches)."""
    ctx = ShardCtx(mesh, multi_pod)
    GB, S = shape.global_batch, shape.seq_len
    Sx = S if shape.kind in ("train", "prefill") else 1
    tok = InputSpec((GB, Sx), torch.int64,
                    ctx.spec_for((GB, Sx), ("batch", None)))
    out = {"tokens": tok}
    if shape.kind == "train":
        out["targets"] = tok
    if cfg.needs_position_ids:
        out["position_ids"] = InputSpec(
            (3, GB, Sx), torch.int64,
            ctx.spec_for((3, GB, Sx), (None, "batch", None)))
    if cfg.enc_dec:
        esh = (GB, cfg.enc_ctx, cfg.d_model)
        out["enc_embeds"] = InputSpec(
            esh, cfg.torch_dtype, ctx.spec_for(esh, ("batch", None, None)))
    return out


def _inputs(cfg, specs, mesh, seed, device):
    """Seeded tensors for ``specs`` (the same on every rank), each laid
    out on ``mesh`` when there is one."""
    gen = torch.Generator().manual_seed(int(seed))
    out = {}
    for name, sp in specs.items():
        if name in ("tokens", "targets"):
            t = torch.randint(0, cfg.vocab_size, sp.shape, generator=gen)
        elif name == "position_ids":
            t = torch.arange(sp.shape[2]).expand(sp.shape).contiguous()
        else:
            t = torch.randn(sp.shape, generator=gen).to(sp.dtype)
        t = t.to(device)
        out[name] = t if mesh is None else distribute(
            t, mesh, placements_for(sp.spec, mesh))
    return out


def _laid_out(tree, specs, mesh):
    return tree_map(lambda t, sp: distribute(t, mesh,
                                             placements_for(sp, mesh)),
                    tree, specs)


def build_cell(cfg: ModelConfig, shape: ShapeCell, mesh=None,
               multi_pod: bool = False, *, device=None,
               seed: int = 0) -> dict:
    """``{"fn", "args"}`` of one cell: ``fn(*args)`` runs its step (the
    train step, a prefill, or a decode step at position 0) on tensors
    laid out on ``mesh`` (under :func:`~repro_torch.dist.sharding.
    use_mesh`, which the caller installs).  A cell whose shape's name
    starts with ``long`` lays out its decode cache and runs its step with
    ``long_ctx`` (the KV sequence on data and model), as the reference
    derives it."""
    dev = resolve_device(device)
    long_ctx = shape.name.startswith("long")
    batch = _inputs(cfg, input_specs(cfg, shape, mesh, multi_pod), mesh,
                    seed, dev)
    if shape.kind == "train":
        state = trainer.make_train_state(seed, cfg, device=dev, mesh=mesh,
                                         multi_pod=multi_pod)

        def fn(st, b):
            return trainer.train_step(cfg, st, b)
        return {"fn": fn, "args": (state, batch)}

    params = lm.init_params(seed, cfg, device=dev)
    if mesh is not None:
        params = _laid_out(params, param_spec_tree(params, cfg, mesh,
                                                   multi_pod), mesh)
    if shape.kind == "prefill":
        def fn(p, b):
            return lm.prefill(cfg, p, b["tokens"],
                              position_ids=b.get("position_ids"),
                              enc_embeds=b.get("enc_embeds"))
        return {"fn": fn, "args": (params, batch)}

    # decode: caches of the cell's length (an encoder-decoder model's
    # cross caches from its encoder over the stub frames)
    GB, S = shape.global_batch, shape.seq_len
    with torch.no_grad():
        enc_out = (lm.encode(cfg, params, batch["enc_embeds"])
                   if cfg.enc_dec else None)
        caches = lm.init_caches(cfg, GB, S, cfg.torch_dtype,
                                enc_out=enc_out,
                                params=params if cfg.enc_dec else None,
                                device=dev)
    if mesh is not None:
        caches = lm.lay_out_caches(cfg, caches, long_ctx=long_ctx, mesh=mesh,
                                   multi_pod=multi_pod)

    def fn(p, c, b, pos):
        return lm.serve_step(cfg, p, c, b["tokens"], pos,
                             position_ids=b.get("position_ids"),
                             long_ctx=long_ctx)
    return {"fn": fn, "args": (params, caches, batch, 0)}
