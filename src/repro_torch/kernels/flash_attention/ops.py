"""Registry declaration and op of flash attention (counterpart of
``repro/kernels/flash_attention/ops.py``).

Tunables: ``block_q`` (query rows per block: 4 or 8 warps of 16 rows)
and ``block_kv`` (the K/V chunk), on the ladders the kernels launch,
which are not the reference's (16 to 256 for both): a warp's mma
fragments are 16 rows tall, and at hd 128 in f32 only chunks of 32 keys
fit beside the q tile and their TF32 split.  The bf16 decode kernel (at
most 16 rows a kv head) takes neither: its key split comes from the
problem and the card.  Validation is to a tolerance, not bit-exact: the
online-softmax rescaling order changes with the chunking.  f32: the
kernel scales q before the dot where the oracle divides the scores, and
its products are 3xTF32 on the tensor cores (about 2^-22 relative per
product, summed in f32), so candidates must match the naive-softmax
plain version to f32 tolerance.  bf16: q.k is one bf16 product of exact
operands, scaled afterwards as the oracle does, and P @ V two (P split
into bf16 hi and lo, 2^-17 of p together), so the f32 results round to
bf16 outputs one ulp from the plain version's at most.

The op is differentiable: the spec's ``backward`` makes
``registry.dispatch`` wrap the call in an autograd function whose
backward is :func:`~.flash_attention.flash_attention_bwd` on the card and
:func:`~.ref.flash_attention_bwd_ref` on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import registry
from repro_torch.kernels.flash_attention.flash_attention import (
    BLOCK_KV, BLOCK_Q, KERNELS, check_shapes, fits, flash_attention,
    flash_attention_bwd)
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

DEFAULT_BLOCK_Q, DEFAULT_BLOCK_KV = 128, 32
#: the bf16 prefill kernel's default tile: 8 warps over chunks of 128 keys
#: (one barrier a chunk), the fastest tile at the LMs' prefill shapes
#: (chip_smoke.py's ``tiles_ms``); the f32 kernel's is the params' own (at
#: hd 128 in f32 only chunks of 32 keys fit)
BF16_DEFAULTS = {"block_q": 128, "block_kv": 128}
#: (rtol, atol) against the plain version on the card, the reference's
#: tolerance: both compute in f32, apart by the order of the softmax's
#: sums, where the 1/sqrt(hd) scale is applied and the 3xTF32 split of
#: each product (tests/test_torch_flash_attention.py emulates it at the
#: llama3.2-3b shape: far inside).  bf16 outputs are held to an rtol of
#: 2**-7 instead, one bf16 ulp: the kernel's bf16 products (P as hi + lo)
#: keep its f32 results that close (emulated there too).
TOL = (2e-5, 2e-5)
#: the backward kernel against the plain backward, each gradient's
#: largest error over its largest magnitude, by input dtype.  The two
#: share their rounding points (D from the o given, group sums in f32,
#: one rounding of each output).  f32: they sum f32 products in another
#: order over up to Skv keys and Sq rows (times the group), and the kernel
#: forms P from the row's log-sum-exp where the plain version normalises
#: exp of the scores: 1e-4.  bf16: f32 results that agree that closely
#: round at most one bf16 step apart, and one ulp of the largest
#: magnitude is at most 2**-7 of it.  Neither bound depends on the head
#: widths: MLA's q.k head of 192 sums 192 products into each score where
#: llama's sums 128, and its v head of 128 enters dO V^T and D as before.
TOL_BWD = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}


def bwd_autograd_tol(dtype, group: int) -> float:
    """The backward (kernel or plain) against autograd of the plain
    version, or jax.grad of the reference's attention, which round
    elsewhere.  f32: ``TOL_BWD``.  bf16, in units of 2**-8 of the largest
    magnitude (at least half an ulp of it): the backward's own rounding
    (1); autograd's rounding of each of the ``group`` q heads' dK and dV
    before their sum and of the ``group - 1`` bf16 additions (2 * group -
    1, each part taken no larger than the sum's largest magnitude); and
    D, which autograd reads from the f32 output and the backward from
    the bf16-rounded o, 2**-8 of each product dO o (2)."""
    if dtype == torch.float32:
        return TOL_BWD[torch.float32]
    return (2 * group + 2) * 2 ** -8
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def inspect_call(q, k, v, *, causal=True, q_offset=0,
                 kv_valid_len=None) -> dict:
    """The reference's problem, and ``hdv``, v's head dim, where it
    differs from ``hd`` (MLA)."""
    B, Sq, H, hd = q.shape
    wide = {} if v.shape[3] == hd else {"hdv": int(v.shape[3])}
    return {"b": int(B), "sq": int(Sq), "skv": int(k.shape[1]),
            "h": int(H), "kv": int(k.shape[2]), "hd": int(hd), **wide,
            "causal": bool(causal), "q_offset": int(q_offset),
            "kv_valid_len": None if kv_valid_len is None
            else int(kv_valid_len),
            "dtype": str(q.dtype).removeprefix("torch.")}


def _run(problem, arrays, params):
    q, k, v = arrays
    return flash_attention(q, k, v, causal=problem["causal"],
                           q_offset=problem["q_offset"],
                           kv_valid_len=problem.get("kv_valid_len"),
                           block_q=params["block_q"],
                           block_kv=params["block_kv"])


def _ref(problem, arrays):
    q, k, v = arrays
    return flash_attention_ref(q, k, v, causal=problem["causal"],
                               q_offset=problem["q_offset"],
                               kv_valid_len=problem.get("kv_valid_len"))


def _make(problem, generator, device):
    def t(*shape):
        return torch.randn(shape, generator=generator).to(
            device=device, dtype=_DTYPES[problem["dtype"]])
    p = problem
    return (t(p["b"], p["sq"], p["h"], p["hd"]),
            t(p["b"], p["skv"], p["kv"], p["hd"]),
            t(p["b"], p["skv"], p["kv"], p.get("hdv", p["hd"])))


def cache_key(problem, backend):
    """The reference's key (q_offset and kv_valid_len leave the tile
    choice correctness-neutral and are not in it), with ``-hdv`` where v's
    head dim differs."""
    p = problem
    hdv = f"-hdv{p['hdv']}" if "hdv" in p else ""
    shape = (f"b{p['b']}-sq{p['sq']}-skv{p['skv']}-h{p['h']}-kv{p['kv']}-"
             f"hd{p['hd']}{hdv}-c{int(p['causal'])}")
    return f"{shape}|{p['dtype']}|{backend}"


def _fits(problem, params):
    """The port's designs, not the Pallas one (which keeps a head's whole
    K/V resident): f32, the q tile, the K/V stages and the split chunk in
    shared memory; bf16, two bf16 K/V stages, at least the q tile
    (:func:`~repro_torch.kernels.flash_attention.flash_attention.fits`)."""
    return fits(problem["hd"], params["block_q"], params["block_kv"],
                problem["dtype"] == "bfloat16", problem.get("hdv"))


def _supports(problem):
    return (problem["dtype"] in _DTYPES and problem["h"] % problem["kv"] == 0
            and fits(problem["hd"], BLOCK_Q[0], BLOCK_KV[0],
                     problem["dtype"] == "bfloat16", problem.get("hdv")))


def candidates(spec, problem, fits_fn):
    """The reference's ladder clip: no tile past the extent rounded up to
    the ladder's smallest rung (16 on the reference's ladders); the
    problem's defaults first."""
    bq, bkv = spec.params
    clip = {"block_q": registry.round_up(problem["sq"], bq.ladder[0]),
            "block_kv": registry.round_up(problem["skv"], bkv.ladder[0])}
    return registry.ladder_candidates(spec.params, clip,
                                      fits=lambda c: fits_fn(problem, c),
                                      defaults=spec.defaults(problem))


def _defaults(problem):
    """``BF16_DEFAULTS`` for bf16 problems, the params' own for f32."""
    if problem["dtype"] == "bfloat16":
        return BF16_DEFAULTS
    return {"block_q": DEFAULT_BLOCK_Q, "block_kv": DEFAULT_BLOCK_KV}


def block_params(block_q=(DEFAULT_BLOCK_Q, BLOCK_Q),
                 block_kv=(DEFAULT_BLOCK_KV, BLOCK_KV)):
    """The two tunables as ``(default, ladder)`` pairs: this kernel's
    by default, the reference's for the int8 kernel."""
    return (registry.TunableParam("block_q", *block_q),
            registry.TunableParam("block_kv", *block_kv))


def _kwargs(problem):
    return dict(causal=problem["causal"], q_offset=problem["q_offset"],
                kv_valid_len=problem.get("kv_valid_len"))


def _bwd_run(problem, arrays, out, grad):
    return flash_attention_bwd(*arrays, out, grad, **_kwargs(problem))


def _bwd_ref(problem, arrays, out, grad):
    return flash_attention_bwd_ref(*arrays, out, grad, **_kwargs(problem))


SPEC = registry.register(registry.KernelSpec(
    name="flash_attention", params=block_params(),
    kernel=flash_attention, run_call=_run, ref_call=_ref, make_call=_make,
    cache_key=cache_key,
    candidates=lambda problem: candidates(SPEC, problem, _fits),
    fits=_fits, supports=_supports, tol=TOL,
    backward=registry.Backward(kernel=flash_attention_bwd, run_call=_bwd_run,
                               ref_call=_bwd_ref),
    parts=KERNELS, problem_defaults=_defaults,
    default_problems=(
        # the reference's: prefill-shaped, square causal, GQA group of 4
        {"b": 1, "sq": 256, "skv": 256, "h": 8, "kv": 2, "hd": 64,
         "causal": True, "q_offset": 0, "dtype": "float32"},
        # decode-window-shaped: short q against a long kv
        {"b": 4, "sq": 32, "skv": 512, "h": 8, "kv": 2, "hd": 64,
         "causal": True, "q_offset": 480, "dtype": "float32"},
    )))


def flash_attention_op(q, k, v, *, causal=True, q_offset=0,
                       kv_valid_len=None, block_q=None, block_kv=None):
    """Attention of q ``[B, Sq, H, hd]`` over k ``[B, Skv, KV, hd]`` and v
    ``[B, Skv, KV, hdv]`` (``hdv`` at most ``hd``: MLA's 128 under its
    192): the plain version on the CPU, the kernel on the card with its
    tiles resolved explicit > tuned > default, and a shape the kernel does
    not take raises there; differentiable in q, k and v on both (on the
    card the backward kernel, which takes the forward's shapes)."""
    check_shapes(q, k, v)
    problem = inspect_call(q, k, v, causal=causal, q_offset=q_offset,
                           kv_valid_len=kv_valid_len)
    return registry.dispatch(SPEC, problem, (q, k, v), q.device,
                             overrides={"block_q": block_q,
                                        "block_kv": block_kv})
