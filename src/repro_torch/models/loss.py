"""Memory-aware cross-entropy and the embedding lookup of the LM
(counterpart of ``repro/models/loss.py``).

``fused_linear_xent`` folds the LM head matmul into a sequence-chunked
loss whose chunks are recomputed in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``): the
full ``[B, S, V]`` logits are never alive, only one ``[B, chunk, Vp]``
f32 block at a time.  ``naive_xent`` is the oracle the tests use.
``embed_lookup``'s backward accumulates the table's gradient in f32, as
the reference's custom VJP does; autograd of ``embed[tokens]`` would sum
repeated tokens in the table's dtype.

Under a mesh (:func:`~repro_torch.dist.sharding.use_mesh`) the tensors
are DTensors and the reference's sharding hints (``constrain``) lay them
out: the hidden states un-shard their sequence before chunking, each
chunk's logits shard the vocabulary, and each token's target logit is
picked vocab-parallel (:func:`_target_logits`: each rank picks from its
own columns, the picks summed as a ``Partial``).  The embedding lookup
is vocab-parallel too (:func:`_sharded_lookup`): each rank looks its
tokens up in its own rows of the table, and the table's gradient stays
in those rows.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import (block_offset, constrain,
                                       current_ctx, distribute, is_dtensor,
                                       matmul, reinstall)

NEG_INF = -1e30


def _masked_logits(x, W, vocab_size):
    """``(x @ W)`` in f32, the padded vocabulary's columns at -1e30."""
    logits = constrain(matmul(x, W), "batch", None, "vocab").to(
        torch.float32)
    if W.shape[1] != vocab_size:
        pad = torch.arange(W.shape[1], device=x.device) >= vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    return logits


def _target_logits(logits, targets):
    """``logits[..., target]``.  A DTensor whose vocabulary is sharded
    is picked vocab-parallel: each rank gathers the targets that fall in
    its own columns (zero elsewhere), and the picks are a ``Partial``
    sum over the vocabulary's mesh dimensions."""
    idx = targets[..., None].long()
    if not is_dtensor(logits):
        return torch.gather(logits, -1, idx)[..., 0]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh, pl, vdim = logits.device_mesh, logits.placements, logits.ndim - 1
    vocab = [i for i, p in enumerate(pl) if p.is_shard(vdim)]
    if not vocab:
        return torch.gather(logits, -1, idx)[..., 0]
    sizes, coord = mesh.shape, mesh.get_coordinate()
    part = 0
    for i in vocab:  # this rank's block of the vocabulary, outer first
        part = part * sizes[i] + coord[i]
    tpl = [Replicate() if i in vocab else p for i, p in enumerate(pl)]

    def pick(local, t):
        width = local.shape[-1]
        t = t - part * width
        inside = (t >= 0) & (t < width)
        got = torch.gather(local, -1, t.clamp(0, width - 1))[..., 0]
        return torch.where(inside[..., 0], got, got.new_zeros(()))

    out = [Partial() if i in vocab else p for i, p in enumerate(pl)]
    return local_map(pick, out_placements=out, in_placements=(list(pl), tpl),
                     device_mesh=mesh, redistribute_inputs=True)(logits, idx)


def _token_losses(logits, targets):
    """``lse - logit[target]`` per token."""
    lse = torch.logsumexp(logits, dim=-1)
    return lse - _target_logits(logits, targets)


def naive_xent(x, W, targets, vocab_size):
    """x ``[B, S, D]`` @ W ``[D, Vp]`` -> mean xent against targets
    ``[B, S]``."""
    return _token_losses(_masked_logits(x, W, vocab_size), targets).mean()


def _chunk_loss(xc, W, tc, vocab_size):
    return _token_losses(_masked_logits(xc, W, vocab_size), tc).sum()


def fused_linear_xent(x, W, targets, vocab_size, chunk: int = 512,
                      unroll: bool = False):
    """Sequence-chunked fused linear + softmax-xent, each chunk's loss
    recomputed in the backward.  The sequence splits into ``max(1, S //
    chunk)`` equal chunks (S must divide), whose summed losses, added in
    order in f32, are divided by ``B * S``.  ``unroll`` is the reference's
    scan option and changes nothing here."""
    B, S, D = x.shape
    nchunk = max(1, S // chunk)
    chunk = S // nchunk
    if S % nchunk:
        raise ValueError(f"sequence {S} does not split into {nchunk} "
                         f"chunks of {chunk}")
    x = constrain(x, "batch", None, None)  # un-shard seq: chunks stay local
    # the head's fsdp dim gathered once, not once a chunk (and again in
    # each chunk's recompute)
    W = constrain(W, None, "vocab")
    ctx = current_ctx()

    def chunk_loss(xc, W, tc):
        with reinstall(ctx):  # the recompute runs in the backward
            return _chunk_loss(xc, W, tc, vocab_size)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(nchunk):
        xc = x[:, c * chunk:(c + 1) * chunk]
        tc = targets[:, c * chunk:(c + 1) * chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(chunk_loss, xc, W, tc,
                                       use_reentrant=False)
        else:
            total = total + _chunk_loss(xc, W, tc, vocab_size)
    return total / (B * S)


class _EmbedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, embed, tokens):
        ctx.save_for_backward(tokens)
        ctx.shape, ctx.dtype = embed.shape, embed.dtype
        return embed[tokens]

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        V, D = ctx.shape
        d_emb = torch.zeros((V, D), dtype=torch.float32, device=g.device)
        d_emb.index_add_(0, tokens.reshape(-1),
                         g.reshape(-1, D).to(torch.float32))
        return d_emb.to(ctx.dtype), None


def embed_lookup(embed, tokens):
    """Rows of ``embed`` ``[V, D]`` at ``tokens`` ``[...]``: ``[..., D]``.
    Its gradient in the table is summed in an f32 ``[V, D]`` buffer and
    cast to the table's dtype.  A DTensor table is looked up
    vocab-parallel (:func:`_sharded_lookup`)."""
    if is_dtensor(embed):
        return _sharded_lookup(embed, tokens)
    if not (torch.is_grad_enabled() and embed.requires_grad):
        return embed[tokens]
    return _EmbedLookup.apply(embed, tokens)


def _sharded_lookup(embed, tokens):
    """The lookup of a DTensor table, vocab-parallel.  The table keeps
    its vocabulary's shards (its other dim is gathered): each rank looks
    up the tokens that fall in its own rows and gives zeros for the
    rest, so the rows are a ``Partial`` sum over the vocabulary's mesh
    dimensions and take the tokens' placements on the others.  The
    table's gradient stays in each rank's rows, a ``Partial`` sum over
    the mesh dimensions the tokens are sharded on (each rank's tokens
    differ there)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = embed.device_mesh
    if not is_dtensor(tokens):
        tokens = distribute(tokens, mesh, [Replicate()] * mesh.ndim)
    vocab = [i for i, p in enumerate(embed.placements) if p.is_shard(0)]
    table = [Shard(0) if i in vocab else Replicate()
             for i in range(mesh.ndim)]
    tpl = [Replicate() if i in vocab else p
           for i, p in enumerate(tokens.placements)]
    out = [Partial() if i in vocab else p for i, p in enumerate(tpl)]
    grad = [Shard(0) if i in vocab else Partial() if p.is_shard()
            else Replicate() for i, p in enumerate(tpl)]
    start = block_offset(mesh, table, 0, embed.shape[0])

    def lookup(rows, t):
        if not vocab:
            return embed_lookup(rows, t)
        t = t - start
        inside = (t >= 0) & (t < rows.shape[0])
        got = embed_lookup(rows, t.clamp(0, rows.shape[0] - 1))
        return torch.where(inside[..., None], got, got.new_zeros(()))

    return local_map(lookup, out_placements=out, in_placements=(table, tpl),
                     in_grad_placements=(grad, tpl), device_mesh=mesh,
                     redistribute_inputs=True)(embed, tokens)
