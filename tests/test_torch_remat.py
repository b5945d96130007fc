"""The port's recomputing forward against its un-recomputed forms and the JAX
package, on the CPU, at small sizes: ``forward(remat=True)`` (the default,
as in the JAX package: each layer group an ``autograd.Function`` that runs
again in the backward) and ``selective_scan``'s per-chunk recompute.

Against the port's own un-recomputed forms the results are bitwise: the same
ops run on the same values in the same order. Against the JAX package
(``forward`` with its default ``remat=True``, ``jax.checkpoint``) the
tolerances already stated: ``selective_scan`` at rtol 1e-5, atol 2e-6
(``test_selective_scan_matches_jax``); the models at ``MODEL_TOL``, with
``SCAN_MODEL_TOL`` for rwkv6 and jamba (``tests/test_torch_families.py``).

What the backward keeps is counted under plain ``torch.autograd``, where
``saved_tensors_hooks`` work (``torch.func.grad`` refuses them): the bytes
of the distinct storages packed for the backward by one ``loss_fn`` call,
those of the parameters left out.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tf
from repro_torch import configs as t_configs
from repro_torch.convert import zoo_params_from_numpy
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_tf

from test_torch_families import SCAN_MODEL_TOL
from test_torch_models import MODEL_TOL

ARCHS = list(j_configs.ARCH_IDS) + ["dynabro-mlp"]
SCAN_TOL = dict(rtol=1e-5, atol=2e-6)  # test_selective_scan_matches_jax's
WORKERS = 3


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=what,
                               **tol)


def _close_model(got, want, what="", atol=MODEL_TOL["atol"]):
    """``MODEL_TOL`` with its atol scaled by the result's magnitude."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, err_msg=what,
                               rtol=MODEL_TOL["rtol"], atol=atol * scale)


def _bitwise(got, want, what=""):
    assert sorted(got) == sorted(want), what
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    assert not differ, f"{what}: not bitwise equal: {differ}"


# ------------------------------------------------------------- the scan


def _scan_inputs(L, Bt=2, di=6, ds=4):
    return dict(
        x=_normal(0, (Bt, L, di)),
        delta=np.log1p(np.exp(_normal(1, (Bt, L, di)))).astype(np.float32),
        A=-np.exp(_normal(2, (di, ds), 0.5)).astype(np.float32),
        B=_normal(3, (Bt, L, ds)), C=_normal(4, (Bt, L, ds)),
        D=_normal(5, (di,)), h0=_normal(6, (Bt, di, ds)))


def _unrecomputed_scan(x, delta, A, B, C, D, h0=None, chunk=256):
    """``selective_scan`` with each chunk's body differentiated in place."""
    return t_ssm._scan_chunks(t_ssm._chunk_body, x, delta, A, B, C, D, h0,
                              chunk)


@pytest.mark.parametrize("L,chunk", [(16, 4), (7, 4), (20, 8), (1, 256)])
def test_chunk_recompute_is_bitwise_and_matches_jax(L, chunk):
    """y, the last state and the gradients of all seven inputs of a weighted
    sum of both, through ``selective_scan`` (each chunk a ``_Chunk``):
    bitwise the un-recomputed scan's under ``torch.func.grad`` and under
    plain autograd, within ``SCAN_TOL`` of ``jax.grad`` through the JAX
    package's (its chunk body under ``jax.checkpoint``). Several chunks,
    a length that is not a multiple of the chunk, and one step."""
    a = _scan_inputs(L)
    names = tuple(a)
    w_y, w_h = _normal(7, a["x"].shape), _normal(8, a["h0"].shape)

    def t_f(scan):
        def f(*args):
            y, h = scan(*args, chunk=chunk)
            return torch.sum(y * _t(w_y)) + torch.sum(h * _t(w_h))
        return f

    def j_f(*args):
        y, h = j_ssm.selective_scan(*args, chunk=chunk)
        return jnp.sum(y * w_y) + jnp.sum(h * w_h)

    ta = [_t(a[n]) for n in names]
    got = t_ssm.selective_scan(*ta, chunk=chunk)
    want = _unrecomputed_scan(*ta, chunk=chunk)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    argnums = tuple(range(len(names)))
    tg = torch.func.grad(t_f(t_ssm.selective_scan), argnums=argnums)(*ta)
    tw = torch.func.grad(t_f(_unrecomputed_scan), argnums=argnums)(*ta)
    _bitwise(dict(zip(names, tg)), dict(zip(names, tw)), "torch.func.grad")
    leaves = [t.clone().requires_grad_() for t in ta]
    ag = torch.autograd.grad(t_f(t_ssm.selective_scan)(*leaves), leaves)
    _bitwise(dict(zip(names, ag)), dict(zip(names, tw)), "autograd")
    jg = jax.grad(j_f, argnums=argnums)(*(jnp.asarray(a[n]) for n in names))
    _close(got[0], j_ssm.selective_scan(*(jnp.asarray(a[n]) for n in names),
                                        chunk=chunk)[0], SCAN_TOL, "y")
    for n, g, j in zip(names, tg, jg):
        _close(g, j, SCAN_TOL, f"d{n}")


# ------------------------------------------------------------- the models


def _batch(cfg, seed, B, S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    if cfg.family == "audio":
        batch["extra"] = {"frames": _normal(seed + 1, (B, cfg.encoder_seq, 64))}
    if cfg.family == "vlm":
        batch["extra"] = {"patches": _normal(seed + 1,
                                             (B, cfg.n_image_tokens, 64))}
    return batch


def _model_inputs(arch, seed=0, B=2, S=12, **kw):
    """Both packages' reduced config (d_model 64), JAX's weights and the
    port's copy of them, and a numpy batch."""
    jcfg = j_configs.get_reduced_config(arch, d_model=64, **kw)
    tcfg = t_configs.get_reduced_config(arch, d_model=64, **kw)
    jp = j_tf.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = zoo_params_from_numpy(jax.tree.map(np.array, jp), device="cpu")
    return jcfg, tcfg, jp, tp, _batch(jcfg, seed, B, S)


def _torch_inputs(arch, seed=0, B=2, S=12, **kw):
    """The port's reduced config, its own weights and a numpy batch, where
    nothing is held against the JAX package."""
    tcfg = t_configs.get_reduced_config(arch, d_model=64, **kw)
    return tcfg, t_tf.init_params(tcfg, seed, device="cpu"), \
        _batch(tcfg, seed, B, S)


@contextlib.contextmanager
def _remat(flag):
    """``loss_fn`` (which calls ``forward`` with its default) with
    ``forward(remat=flag)``."""
    orig = t_tf.forward
    t_tf.forward = functools.partial(orig, remat=flag)
    try:
        yield
    finally:
        t_tf.forward = orig


def _loss(remat, cfg):
    def f(p, b):
        with _remat(remat):
            return t_tf.loss_fn(p, b, cfg)
    return f


def test_remat_is_the_default(monkeypatch):
    """``forward``'s ``remat`` defaults to True, as the JAX package's does:
    in train mode one ``_Group`` a layer group; none with remat=False or in
    prefill mode."""
    import inspect
    assert inspect.signature(t_tf.forward).parameters["remat"].default is True
    assert inspect.signature(j_tf.forward).parameters["remat"].default is True
    tcfg, tp, batch = _torch_inputs("smollm-360m")
    toks = _t(batch["tokens"])
    calls = []
    orig = t_tf._Group.apply
    monkeypatch.setattr(t_tf._Group, "apply",
                        lambda *a: calls.append(a) or orig(*a))
    t_tf.forward(tp, toks, tcfg)
    assert len(calls) == tcfg.n_groups == 2
    t_tf.forward(tp, toks, tcfg, remat=False)
    t_tf.forward(tp, toks, tcfg, mode="prefill")
    assert len(calls) == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_loss_and_grad_bitwise_and_match_jax(arch):
    """Every arch of the registry at ``reduced`` (SmolLM's and whisper's
    decoder two layer groups, llama-3.2-vision's and jamba's one): the loss
    and every leaf's gradient of ``loss_fn`` with ``forward(remat=True)``
    bitwise those with ``remat=False``, then against the JAX package's
    ``loss_fn`` and its gradient (``remat=True``) at the stated
    tolerances."""
    jcfg, tcfg, jp, tp, batch = _model_inputs(arch, seed=1)
    tb = jax.tree.map(_t, batch)
    loss_r, loss_0 = _loss(True, tcfg)(tp, tb), _loss(False, tcfg)(tp, tb)
    assert torch.equal(loss_r, loss_0)
    assert torch.equal(loss_r, t_tf.loss_fn(tp, tb, tcfg))
    g_r = torch.func.grad(lambda p: t_tf.loss_fn(p, tb, tcfg))(tp)
    g_0 = torch.func.grad(_loss(False, tcfg))(tp, tb)
    _bitwise(g_r, g_0, arch)
    atol = SCAN_MODEL_TOL.get(arch, (None, MODEL_TOL["atol"]))[1]
    j_loss, j_grad = jax.value_and_grad(j_tf.loss_fn)(
        jp, jax.tree.map(jnp.asarray, batch), jcfg)
    _close_model(loss_r, j_loss, "loss")
    want = zoo_params_from_numpy(jax.tree.map(np.array, j_grad), device="cpu")
    assert sorted(g_r) == sorted(want)
    for k in want:
        _close_model(g_r[k], want[k], k, atol)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_under_vmap_grad_is_bitwise(arch):
    """``torch.func.vmap(torch.func.grad(loss))`` over 3 workers' batches,
    as ``core.robust_train._stream_levels`` calls it: remat=True's worker
    gradients bitwise remat=False's."""
    tcfg, tp, batch = _torch_inputs(arch)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tcfg.vocab_size,
                        size=(WORKERS,) + batch["tokens"].shape)
    stack = {"tokens": _t(toks), "labels": _t(np.roll(toks, -1, 2))}
    if "extra" in batch:
        stack["extra"] = {k: _t(_normal(6, (WORKERS,) + v.shape))
                          for k, v in batch["extra"].items()}

    def worker_grads(remat):
        return torch.func.vmap(torch.func.grad(_loss(remat, tcfg)),
                               in_dims=(None, 0))(tp, stack)

    _bitwise(worker_grads(True), worker_grads(False), arch)


def test_remat_gradient_reaches_kv_src():
    """Whisper (reduced: two decoder groups over the encoder's output): the
    gradient through kv_src to the encoder's leaves and to the frames
    themselves, summed over the groups, bitwise remat=False's and not zero;
    the frames' within ``MODEL_TOL`` of JAX's."""
    jcfg, tcfg, jp, tp, batch = _model_inputs("whisper-base", seed=2)
    assert tcfg.n_groups >= 2
    frames = batch["extra"]["frames"]

    def t_f(remat):
        def f(p, fr):
            b = {"tokens": _t(batch["tokens"]), "labels": _t(batch["labels"]),
                 "extra": {"frames": fr}}
            return _loss(remat, tcfg)(p, b)
        return f

    g_r = torch.func.grad(t_f(True), argnums=(0, 1))(tp, _t(frames))
    g_0 = torch.func.grad(t_f(False), argnums=(0, 1))(tp, _t(frames))
    _bitwise(g_r[0], g_0[0], "params")
    assert torch.equal(g_r[1], g_0[1])
    enc = [k for k in g_r[0] if k.startswith("encoder/")]
    assert enc and all(float(g_r[0][k].abs().max()) > 0 for k in enc)
    assert float(g_r[1].abs().max()) > 0

    def j_f(fr):
        b = dict(batch, extra={"frames": fr})
        return j_tf.loss_fn(jp, jax.tree.map(jnp.asarray, b), jcfg)

    _close_model(g_r[1], jax.grad(j_f)(jnp.asarray(frames)), "d frames")


def test_remat_gradient_reaches_router_aux():
    """An MoE arch (qwen2-moe, reduced, router_aux_weight > 0): the
    gradient of ``forward``'s router aux alone, bitwise remat=False's, not
    zero at the routers, and within ``MODEL_TOL`` of JAX's."""
    jcfg, tcfg, jp, tp, batch = _model_inputs("qwen2-moe-a2.7b", seed=3)
    assert tcfg.router_aux_weight > 0 and tcfg.n_groups >= 2
    toks = _t(batch["tokens"])

    def aux_of(remat):
        return lambda p: t_tf.forward(p, toks, tcfg, remat=remat)[1]

    g_r = torch.func.grad(aux_of(True))(tp)
    _bitwise(g_r, torch.func.grad(aux_of(False))(tp), "aux")
    router = [k for k in g_r if k.endswith("moe/router")]
    assert router and all(float(g_r[k].abs().max()) > 0 for k in router)
    want = jax.grad(lambda p: j_tf.forward(p, jnp.asarray(batch["tokens"]),
                                           jcfg)[1])(jp)
    want = zoo_params_from_numpy(jax.tree.map(np.array, want), device="cpu")
    for k in router:
        _close_model(g_r[k], want[k], k)


# ------------------------------------------------------------- memory


def _saved_bytes(fn, params):
    """Bytes of the distinct storages that one call of ``fn`` packs for its
    backward, the storages of ``params`` left out."""
    own = {v.untyped_storage().data_ptr() for v in params.values()}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in own:
            seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(seen.values())


@contextlib.contextmanager
def _unrecomputed_chunks():
    orig = t_ssm.selective_scan
    t_ssm.selective_scan = _unrecomputed_scan
    try:
        yield
    finally:
        t_ssm.selective_scan = orig


# (arch, reduced kw, what is compared, the largest share kept). Measured
# (float32, batch 2, seq 32, d_model 64): jamba with remat=True keeps 1.16 %
# of what the un-recomputed model (its chunks too) keeps (328,704 of
# 28,280,384 bytes), and the chunk recompute alone (remat=False) 27.8 %;
# SmolLM with 4 layer groups, remat=True 23.9 % of remat=False.
MEMORY_CASES = [("jamba-1.5-large-398b", {}, "remat", 1 / 20),
                ("jamba-1.5-large-398b", {}, "chunks", 1 / 2),
                ("smollm-360m", {"n_layers": 4}, "remat", 1 / 3)]


@pytest.mark.parametrize("arch,kw,what,share", MEMORY_CASES)
def test_recompute_keeps_less(arch, kw, what, share):
    """What one ``loss_fn`` call keeps for its backward: with remat=True
    ("remat": against remat=False with un-recomputed chunks), or with the
    chunk recompute at remat=False ("chunks": against un-recomputed
    chunks), at most ``share`` of the un-recomputed model's. The backward
    then runs and gives the un-recomputed model's gradient."""
    tcfg, tp, batch = _torch_inputs(arch, S=32, **kw)
    assert tcfg.n_groups == kw.get("n_layers", tcfg.n_groups)
    tb = jax.tree.map(_t, batch)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    names = sorted(leaves)

    def run(remat, chunks):
        with contextlib.ExitStack() as stack:
            if not chunks:
                stack.enter_context(_unrecomputed_chunks())
            out = {}
            kept = _saved_bytes(lambda: out.update(
                loss=_loss(remat, tcfg)(leaves, tb)), leaves)
            grads = torch.autograd.grad(out["loss"],
                                        [leaves[k] for k in names])
        return kept, dict(zip(names, grads))

    base, want = run(False, False)
    kept, got = run(what == "remat", True)
    assert kept <= share * base, (arch, what, kept, base, kept / base)
    _bitwise(got, want, f"{arch} {what}")
