"""Port parity: every family's prefill, decode step and training step
under a mesh, on the CPU.

One spawned gloo group of four ranks laid out data 2 x model 2 runs each
registered family (reduced, f32, one repeat of its pattern, the
reference's weights through ``lm.params_from_jax``; jamba at slots 3-5
of its period) through
``tests/torch_dist_model_workers.py``, through the step functions of
its ``build_cell`` cells: the prefill cell on 2 x 8 tokens; a prefill
into a 12-position cache laid out by ``cache_spec_tree`` ("kvseq"), then
the decode cell (``long_ctx=False``); row 0 of that cache laid out with
``long_ctx=True`` ("longseq": data and model, since one row leaves the
data axis to the sequence), then the long decode cell; the train
cell's step, its loss and every gradient kept as it computes them.  While the ranks run, this
process computes the reference's (``jlm.prefill``, ``jlm.serve_step``,
``jax.value_and_grad`` of ``jlm.train_loss``) and the port's on one rank.

Limits (``tests/test_torch_dist_train.py``'s): the loss within rtol
1e-5, each gradient within 1e-4 of its leaf's largest magnitude, logits
and every cache within 1e-4 of their largest magnitude (f32: summation
order only; the batch-1 results against the reference's row 0), but
a key bias's gradient, zero in exact arithmetic, is held to zero within
1e-6 of its layer's ``wk`` gradient (``tests/test_torch_whisper.py``).  An
int8 cache is held dequantized, within one quantization step of its
row's scale (a value on a rounding boundary may round the other way).

Beside the parity: the registry never receives a DTensor on any rank,
each family's kernels ran on every rank, a decode step moves the cache
along its sequence (collectives counted), ``moe_apply``'s backward under
the mesh goes through the adjoint pair, and without a mesh it is bit for
bit the autograd of its scatter and gather, and ``jax.vjp``'s within the
limits above.
"""
import functools
import json
import os
import pickle
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from test_torch_dist import ROOT, _env  # noqa: E402
import torch_dist_model_workers as workers  # noqa: E402

TOL, LOSS_RTOL = 1e-4, 1e-5
#: a gradient that is zero in exact arithmetic (``bk``'s), as a share of
#: the largest gradient of the same layer's ``wk``
ZERO_GRAD_TOL = 1e-6
NAMES = workers.FAMILIES + workers.VARIANTS
TRAINED = tuple(n for n in NAMES if n not in workers.SERVE_ONLY)

_WORKER = r"""
import sys
sys.path.insert(0, "tests")
from torch_dist_model_workers import worker_main
worker_main(sys.argv[1:])
"""
# the families whose reference a second process computes, beside this
# one (on one process the reference takes longer than the ranks); split
# by the reference's time on the CPU
HELPED = (("jamba-v0.1-52b", "deepseek-v2-lite-16b", "qwen3-4b"),)
_HELPER = r"""
import sys
sys.path.insert(0, "tests")
from test_torch_dist_models import produce
produce(sys.argv[1], sys.argv[2].split(","))
"""


def _jconfig(name):
    return workers.cut(jarchs.reduced(jbase.get_config(
        name.partition(":")[0])), name)


def _reference(name, jparams, inp):
    """The reference's prefill logits and caches, one decode step's, and
    the training loss and gradients, as numpy."""
    cfg = _jconfig(name)
    kw = {k: jnp.asarray(inp[k]) for k in ("position_ids", "enc_embeds")
          if k in inp}
    toks = jnp.asarray(inp["tokens"], jnp.int32)

    def serve(p, t, kw):
        logits, caches = jlm.prefill(cfg, p, t[:, :workers.S],
                                     cache_len=workers.CACHE, **kw)
        return {"prefill": (logits, caches),
                "decode": jlm.serve_step(cfg, p, caches,
                                         t[:, workers.S:], workers.S)}
    out = jax.jit(serve)(jparams, toks, kw)
    if name in TRAINED:
        batch = dict(kw, tokens=toks[:, :workers.S], targets=toks[:, 1:])
        out["train"] = jax.jit(jax.value_and_grad(
            lambda p, b: jlm.train_loss(cfg, p, b)))(jparams, batch)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), out)


def produce(tmp, names):
    """For each of ``names``: the reference's weights and the inputs for
    the ranks (``<i>.pkl``, ``i`` its index in ``NAMES``), written as soon
    as each is made, then the reference's results (``<i>.ref.pkl``)."""
    import pathlib
    tmp, models = pathlib.Path(tmp), {}
    for name in names:
        arch = name.removesuffix(":int8")  # an int8 cache: the weights
        if arch not in models:
            cfg = _jconfig(name)
            init = functools.partial(jlm.init_params, cfg=cfg)
            if any(s.mlp == "moe" or s.mixer != "gqa"
                   for s in cfg.prefix + cfg.pattern):
                init = jax.jit(init)  # one compile, not one an op
            jparams = init(jax.random.PRNGKey(0))
            models[arch] = (jparams, jax.tree.map(np.asarray, jparams))
        _write(tmp / f"{NAMES.index(name)}.pkl",
               (models[arch][1], workers.inputs(workers.config(name))))
    for name in names:
        jparams, tree = models[name.removesuffix(":int8")]
        _write(tmp / f"{NAMES.index(name)}.ref.pkl",
               _reference(name, jparams,
                          workers.inputs(workers.config(name))))


def _write(path, obj):
    """``obj`` pickled to ``path`` whole or not at all (the ranks poll)."""
    part = path.with_suffix(".part")
    with open(part, "wb") as f:
        pickle.dump(obj, f)
    os.replace(part, path)


def _start(script, n, *args):
    return [subprocess.Popen(
        [sys.executable, "-c", script, *(str(a(r)) if callable(a) else
                                         str(a) for a in args)],
        env=_env(), cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(n)]


def _finish(procs, timeout=600):
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            p.kill()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Per family: the reference's results, the port's on one rank, the
    sharded run's (rank 0's arrays) and every rank's report.  The ranks
    start first and take each family as its weights appear; this process
    and a helper make the weights and the reference's results, then this
    one runs the port on one rank."""
    tmp = tmp_path_factory.mktemp("dist_models")
    (tmp / "names.json").write_text(json.dumps(list(NAMES)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = _start(_WORKER, 4, lambda r: r, 4, port, tmp)
    for names in HELPED:
        procs += _start(_HELPER, 1, tmp, ",".join(names))
    try:
        produce(tmp, [n for n in NAMES
                      if not any(n in names for names in HELPED)])
        out = {}
        for i, name in enumerate(NAMES):
            with open(tmp / f"{i}.pkl", "rb") as f:
                tree, inp = pickle.load(f)
            out[name] = {"one": workers.run_family(name, tree, inp)[0]}
    finally:
        _finish(procs)
    for i, name in enumerate(NAMES):
        with open(tmp / f"{i}.ref.pkl", "rb") as f:
            out[name]["ref"] = pickle.load(f)
        out[name]["mesh"] = dict(np.load(tmp / f"{i}.npz"))
        out[name]["meta"] = [json.loads((tmp / f"{i}.rank{r}.json")
                                        .read_text()) for r in range(4)]
    return out


def _close(got, want, what, tol=TOL):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


def _ref_cache(jcaches, key, rows):
    """The reference's cache leaf at the port's path ``key``
    (``stack/<slot>/<repeat>/...`` or ``prefix/<i>/...``), batch
    ``rows``."""
    parts = key.split("/")
    if parts[0] == "stack":
        node, r, rest = jcaches["stack"][int(parts[1])], int(parts[2]), \
            parts[3:]
    else:
        node, r, rest = jcaches["prefix"][int(parts[1])], None, parts[2:]
    for k in rest:
        node = node[k]
    return (node if r is None else node[r])[rows]


SEQ_CACHES = ("mixer/k", "mixer/v", "mixer/ckv", "mixer/kr")


def _dequantized(arrays, prefix, key):
    return arrays[f"{prefix}/{key}"] * arrays[f"{prefix}/{key}_scale"][
        ..., None]


def _check_serving(m, name, phase, jphase, rows):
    """``phase``'s logits and every cache leaf of the sharded run against
    the one-rank run and the reference's ``jphase`` at ``rows``."""
    V = workers.config(name).vocab_size
    jlogits, jcaches = m["ref"][jphase]
    for other, want in (("one", m["one"][f"{phase}/logits"]),
                        ("ref", jlogits[rows])):
        _close(m["mesh"][f"{phase}/logits"][:, :V], want[:, :V],
               (other, phase, "logits"))
    keys = [k.split("/cache/", 1)[1] for k in m["mesh"]
            if k.startswith(f"{phase}/cache/")]
    assert keys and set(keys) == {k.split("/cache/", 1)[1] for k in m["one"]
                                  if k.startswith(f"{phase}/cache/")}
    for key in keys:
        if key.endswith("_scale"):
            continue
        got = m["mesh"][f"{phase}/cache/{key}"]
        ref = _ref_cache(jcaches, key, rows)
        one = m["one"][f"{phase}/cache/{key}"]
        tol = TOL
        if f"{phase}/cache/{key}_scale" in m["mesh"]:  # int8
            got = _dequantized(m["mesh"], f"{phase}/cache", key)
            one = _dequantized(m["one"], f"{phase}/cache", key)
            ref = ref * _ref_cache(jcaches, key + "_scale", rows)[..., None]
            tol = 1.0 / 127 + TOL  # one step of the row's scale
        if key.endswith(SEQ_CACHES) and ref.shape[1] != got.shape[1]:
            # the prefill cell's cache holds the prompt; the reference's
            # all CACHE positions, zeros past the prompt
            assert not ref[:, got.shape[1]:].any()
            ref = ref[:, :got.shape[1]]
        _close(got, one, ("one", phase, key), tol)
        _close(got, ref, ("ref", phase, key), tol)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_under_a_mesh_matches_reference_and_one_rank(run, name):
    """The prefill cell on the 2 x 8-token prompt: logits and every
    cache leaf."""
    _check_serving(run[name], name, "prefill", "prefill", slice(None))


@pytest.mark.parametrize("long_ctx", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_decode_step_under_a_mesh_matches_reference_and_one_rank(
        run, name, long_ctx):
    """The decode cell at position 8 after a prefill into 12 positions:
    ``long_ctx`` False at batch 2, True at row 0 alone (its cache laid
    out on ``"longseq"``); logits and every cache leaf, the cache's
    placements and the collectives the step moved."""
    m = run[name]
    phase = "decode_long" if long_ctx else "decode"
    _check_serving(m, name, phase, "decode",
                   slice(0, 1) if long_ctx else slice(None))
    # kvseq: the sequence on model; longseq at one row: on data and
    # model (the batch leaves the data axis to it)
    want = {"decode": "(Shard(dim=0), Shard(dim=1))",
            "decode_long": "(Shard(dim=1), Shard(dim=1))"}[phase]
    for meta in m["meta"]:
        if name.startswith("rwkv6"):  # recurrent: no sequence cache
            assert not meta["cache_placements"]
            continue
        assert meta["cache_placements"][phase] == want
        assert sum(meta["collectives"][phase].values()) > 0


@pytest.mark.parametrize("name", TRAINED)
def test_train_step_under_a_mesh_matches_reference_and_one_rank(run, name):
    """The train cell's step: its loss and every gradient, and the loss
    and gradient norm it returns against one rank's."""
    m = run[name]
    jloss, jgrads = m["ref"]["train"]
    np.testing.assert_allclose(m["mesh"]["train/loss"], jloss,
                               rtol=LOSS_RTOL)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(m["mesh"][f"train_step/{k}"],
                                   m["one"][f"train_step/{k}"],
                                   rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["mesh"]["train/loss"], m["one"]["train/loss"],
                               rtol=LOSS_RTOL)
    keys = [k for k in m["mesh"] if k.startswith("train/grad/")]
    assert set(keys) == {k for k in m["one"] if k.startswith("train/grad/")}
    for key in keys:
        path = key.split("train/grad/", 1)[1]
        got, one, ref = (m["mesh"][key], m["one"][key],
                         _ref_grad(jgrads, path))
        if path.endswith("/bk") and workers.config(name).rope == "none":
            # without a rotation the softmax cancels q . bk: zero in
            # exact arithmetic, rounding noise in every package; held
            # to zero (tests/test_torch_whisper.py)
            scale = np.abs(_ref_grad(jgrads, path[:-2] + "wk")).max()
            for g in (got, one, ref):
                assert np.abs(g).max() <= ZERO_GRAD_TOL * scale, path
            continue
        _close(got, one, ("one", path))
        _close(got, ref, ("ref", path))


def _ref_grad(jgrads, path):
    parts = path.split("/")
    if parts[0] == "stack":
        node, r, rest = jgrads["stack"][int(parts[1])], int(parts[2]), \
            parts[3:]
    elif parts[0] == "prefix":
        node, r, rest = jgrads["prefix"][int(parts[1])], None, parts[2:]
    elif parts[0] == "encoder" and parts[1] == "stack":
        node, r, rest = jgrads["encoder"]["stack"][int(parts[2])], \
            int(parts[3]), parts[4:]
    else:
        node, r, rest = jgrads, None, parts
    for k in rest:
        node = node[k]
    return node if r is None else node[r]


@pytest.mark.parametrize("name", NAMES)
def test_kernels_ran_on_every_rank_on_local_tensors(run, name):
    """The registry saw no DTensor on any rank, and each of the family's
    kernels ran (its plain version, on the CPU) on every rank."""
    cfg = workers.config(name)
    mixers = {s.mixer for s in list(cfg.prefix) + list(cfg.pattern)}
    want = {"flash_attention": bool(mixers & {"gqa", "mla"}),
            "mamba_scan": "mamba" in mixers,
            "rwkv6_chunk": "rwkv6" in mixers}
    for meta in run[name]["meta"]:
        assert meta.get("dtensor_dispatches", 0) == 0
        for k, ran in want.items():
            assert (meta["plain_calls"][k] > 0) == ran, (k, meta)


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "jamba-v0.1-52b",
                                  "grok-1-314b"])
def test_moe_backward_under_a_mesh_goes_through_the_adjoint_pair(run, name):
    for meta in run[name]["meta"]:
        assert meta.get("_DispatchScatter", 0) > 0
        assert meta.get("_CombineGather", 0) > 0


# ------------------------------------------- the MoE adjoint, no mesh -----
def _moe_by_autograd(cfg, p, x):
    """``moe_apply`` as the port wrote it before the adjoint pair: the
    dispatch an ``index_put_`` and the combine an advanced-index gather,
    both differentiated by autograd."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = blocks._moe_groups(B * S)
    Tg = B * S // G
    xg = x.reshape(G, Tg, d)
    gates, experts, rows, keep, C = blocks.moe_route(cfg, p, xg)
    group = torch.arange(G)[:, None].expand(G, Tg * k)
    upd = xg.repeat_interleave(k, dim=1) * keep[..., None].to(x.dtype)
    buf = x.new_zeros((G, E, C + 1, d)).index_put_((group, experts, rows),
                                                   upd)
    xin = buf[:, :, :C]
    act = blocks._act(cfg.act)
    h = act(torch.einsum("gecd,edf->gecf", xin, p["we1"])) * \
        torch.einsum("gecd,edf->gecf", xin, p["we3"])
    out_e = F.pad(torch.einsum("gecf,efd->gecd", h, p["we2"]),
                  (0, 0, 0, 1))
    w = (gates.reshape(G, Tg * k) * keep.to(torch.float32)).to(x.dtype)
    y = (out_e[group, experts, rows] * w[..., None]).reshape(
        G, Tg, k, d).sum(dim=2)
    if cfg.n_shared_experts:
        y = y + (act(xg @ p["ws1"]) * (xg @ p["ws3"])) @ p["ws2"]
    return y.reshape(B, S, d)


@pytest.mark.parametrize("name,capacity", [
    ("deepseek-v2-lite-16b", None), ("grok-1-314b", 0.5)])
def test_moe_adjoint_without_a_mesh_is_autograd_bit_for_bit(name, capacity):
    """Without a mesh the adjoint pair gives autograd's gradients of the
    scatter and the gather bit for bit (with shared experts, and at a
    capacity that drops routes), and ``jax.vjp``'s of the reference's
    ``moe_apply`` within the gradients' limit."""
    cfg = workers.config(name)
    jcfg = _jconfig(name)
    if capacity is not None:
        cfg = cfg.replace(capacity_factor=capacity)
        jcfg = jcfg.replace(capacity_factor=capacity)
    jp = jblocks.mlp_init(jax.random.PRNGKey(3), jcfg, "moe")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    grads = []
    for fn in (lambda p, t: blocks.moe_apply(cfg, p, t)[0],
               lambda p, t: _moe_by_autograd(cfg, p, t)):
        p = {k: torch.from_numpy(np.asarray(v)).requires_grad_(True)
             for k, v in jp.items()}
        xt = torch.from_numpy(x).requires_grad_(True)
        y = fn(p, xt)
        g = torch.autograd.grad(y, [xt] + [p[k] for k in sorted(p)],
                                torch.from_numpy(dy))
        grads.append((y.detach(), g))
    (y, g), (y0, g0) = grads
    assert torch.equal(y, y0)
    assert all(torch.equal(a, b) for a, b in zip(g, g0))

    def vjp(p, t, c):
        out, back = jax.vjp(lambda p, t: jblocks.moe_apply(jcfg, p, t)[0],
                            p, t)
        return out, back(c)
    jy, (jgp, jgx) = jax.jit(vjp)(jp, jnp.asarray(x), jnp.asarray(dy))
    _close(y.numpy(), np.asarray(jy), "y")
    _close(g[0].numpy(), np.asarray(jgx), "x")
    for got, k in zip(g[1:], sorted(jp)):
        _close(got.numpy(), np.asarray(jgp[k]), k)
