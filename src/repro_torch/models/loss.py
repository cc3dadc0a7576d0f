"""Memory-aware cross-entropy and the embedding lookup of the LM
(counterpart of ``repro/models/loss.py``).

``fused_linear_xent`` folds the LM head matmul into a sequence-chunked
loss whose chunks are recomputed in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``): the
full ``[B, S, V]`` logits are never alive, only one ``[B, chunk, Vp]``
f32 block at a time.  ``naive_xent`` is the oracle the tests use.
``embed_lookup``'s backward accumulates the table's gradient in f32, as
the reference's custom VJP does; autograd of ``embed[tokens]`` would sum
repeated tokens in the table's dtype.  The reference's sharding hints
(``constrain``) are no-ops without a mesh and are dropped.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def _masked_logits(x, W, vocab_size):
    """``(x @ W)`` in f32, the padded vocabulary's columns at -1e30."""
    logits = (x @ W).to(torch.float32)
    if W.shape[1] != vocab_size:
        pad = torch.arange(W.shape[1], device=x.device) >= vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    return logits


def _token_losses(logits, targets):
    """``lse - logit[target]`` per token."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return lse - tgt


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
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(nchunk):
        xc = x[:, c * chunk:(c + 1) * chunk]
        tc = targets[:, c * chunk:(c + 1) * chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_loss, xc, W, tc, vocab_size,
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
    cast to the table's dtype."""
    if not (torch.is_grad_enabled() and embed.requires_grad):
        return embed[tokens]
    return _EmbedLookup.apply(embed, tokens)
