"""The port's model zoo layers and dense transformer (``repro_torch.models``)
against the JAX package's ``repro.models``, on the CPU, at small sizes; the
other families' forward pass in brief (``tests/test_torch_families.py``
holds them in full).

Both packages get the same numpy inputs; the JAX weights come across through
``convert.zoo_params_from_numpy``. Tolerances, float32 throughout:

- ``rms_norm``, ``layer_norm``, RoPE, ``chunked_attention`` and the ``mlp``:
  rtol 1e-5, atol 1e-6 (the same float32 formulas; transcendental and
  summation order may differ by a few ulps);
- the forward pass's logits, ``loss_fn`` and its gradient: rtol 1e-4, atol
  1e-6 times the larger of 1 and the largest |value| of the JAX result (a
  few layers of products summed in another order, and the embedding's
  gradient summed by a one-hot product where JAX scatters: the rounding is
  relative to the magnitudes summed, so a logit near 0 among logits of 4
  differs by a few 1e-6; measured at most 1e-6 of the largest logit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import layers as j_layers
from repro.models import transformer as j_tf
from repro_torch import configs as t_configs
from repro_torch import models as t_models
from repro_torch.convert import zoo_params_from_numpy, zoo_params_to_numpy
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tf

LAYER_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-4, atol=1e-6)
DENSE = [a for a in j_configs.ARCH_IDS
         if j_configs.get_config(a).family == "dense"] + ["dynabro-mlp"]
UNPORTED = [a for a in j_configs.ARCH_IDS  # the non-dense families
            if j_configs.get_config(a).family != "dense"]


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(seed, shape, scale=1.0):
    return (_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=what,
                               **tol)


def _close_model(got, want, what=""):
    """``MODEL_TOL`` with its atol scaled by the result's magnitude."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, err_msg=what,
                               rtol=MODEL_TOL["rtol"],
                               atol=MODEL_TOL["atol"] * scale)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(arch, **kw):
    return (j_configs.get_reduced_config(arch, **kw),
            t_configs.get_reduced_config(arch, **kw))


def _flat_jax(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(p.key for p in path)] = leaf
    return out


# ------------------------------------------------------------- the configs


def test_config_registry_is_the_jax_packages():
    assert t_configs.ARCH_IDS == j_configs.ARCH_IDS
    for arch in j_configs.ARCH_IDS + ["dynabro-mlp"]:
        j, t = j_configs.get_config(arch), t_configs.get_config(arch)
        assert vars(j) == vars(t), arch
        assert t.param_count() == j.param_count()
        assert t.pattern() == j.pattern()
        assert vars(t_configs.reduced(t)) == vars(j_configs.reduced(j))
    assert t_configs.SHAPES.keys() == j_configs.SHAPES.keys()
    with pytest.raises(KeyError, match="unknown arch"):
        t_configs.get_config("nosuch")


# ------------------------------------------------------------- the params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_init_params_tree_is_the_jax_packages(arch, dtype):
    """Leaf names (the JAX tree paths joined by "/"), shapes and dtypes of
    every dense arch, reduced; the draws' scales match the JAX package's."""
    jcfg, tcfg = _cfgs(arch)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = _flat_jax(jax.eval_shape(
        lambda k: j_tf.init_params(jcfg, k, jd), jax.random.PRNGKey(0)))
    got = t_models.init_params(tcfg, 0, td, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype), k
    jp = _flat_jax(j_tf.init_params(jcfg, jax.random.PRNGKey(0), jd))
    for k in want:
        j_std = float(np.asarray(jp[k], np.float32).std())
        t_std = float(got[k].float().std())
        assert abs(t_std - j_std) <= 0.1 * j_std + 1e-7, (k, t_std, j_std)
    if arch == "smollm-360m":
        assert len(got) == 11  # one tree launch of the reduce


def test_init_params_draws_a_seed_on_every_device_alike():
    _, cfg = _cfgs("smollm-360m", d_model=32)
    a = t_models.init_params(cfg, 3, device="cpu")
    b = t_models.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = t_models.init_params(cfg, 4, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])


def test_zoo_params_round_trip():
    jcfg, _ = _cfgs("qwen3-0.6b", d_model=32)
    tree = jax.tree.map(np.asarray, j_tf.init_params(jcfg, jax.random.PRNGKey(1)))
    flat = zoo_params_from_numpy(tree, device="cpu")
    assert "blocks/b0/mix/q_norm" in flat
    back = zoo_params_to_numpy(flat)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- the layers


def test_rms_norm_and_layer_norm_match_jax():
    x, s, b = _normal(0, (2, 5, 48)), _normal(1, (48,)), _normal(2, (48,))
    _close(t_layers.rms_norm(_t(x), _t(s)), j_layers.rms_norm(x, s), LAYER_TOL)
    _close(t_layers.layer_norm(_t(x), _t(s), _t(b)),
           j_layers.layer_norm(x, s, b), LAYER_TOL)
    for kind in ("rmsnorm", "layernorm"):
        _close(t_layers.apply_norm(_t(x), {"scale": _t(s), "bias": _t(b)}, kind),
               j_layers.apply_norm(x, {"scale": s, "bias": b}, kind), LAYER_TOL)


@pytest.mark.parametrize("pos_shape", [(16,), (1,), ()],
                         ids=["S_half", "one_half", "half"])
def test_rope_matches_jax(pos_shape):
    """``rope_angles`` and ``apply_rope`` with cos/sin of (S, half), of (1,
    half) (a decode position) and of (half,): the JAX package's broadcast
    loop."""
    hd, theta = 32, 1e4
    pos = np.arange(int(np.prod(pos_shape)), dtype=np.int32).reshape(pos_shape) + 3
    jc, js = j_layers.rope_angles(jnp.asarray(pos), hd, theta)
    tc, ts = t_layers.rope_angles(_t(pos), hd, theta)
    _close(tc, jc, LAYER_TOL)
    _close(ts, js, LAYER_TOL)
    S = pos_shape[0] if pos_shape else 16
    x = _normal(3, (2, S, 3, hd))
    _close(t_layers.apply_rope(_t(x), tc, ts),
           j_layers.apply_rope(x, jc, js), LAYER_TOL)


ATTN_CASES = [  # causal, window, q_chunk, kv_chunk, Sq, Skv, H, KV
    (True, 0, 1024, 1024, 16, 16, 4, 2),
    (True, 5, 1024, 1024, 16, 16, 4, 2),
    (True, 0, 4, 8, 13, 13, 4, 1),
    (True, 6, 8, 4, 13, 13, 2, 2),
    (False, 0, 8, 5, 11, 17, 6, 3),
]


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=lambda c: "causal{}-w{}-q{}-kv{}-S{}x{}-H{}/{}".format(*c))
def test_chunked_attention_matches_jax(case):
    """Causal and windowed, one chunk and several (padded), GQA; the values
    and the gradient of a weighted sum of the output."""
    causal, window, qc, kc, Sq, Skv, H, KV = case
    hd = 8
    q, k, v = (_normal(s, (2, n, h, hd)) for s, n, h in
               ((0, Sq, H), (1, Skv, KV), (2, Skv, KV)))
    w = _normal(3, (2, Sq, H, hd))
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc)

    def j_f(q, k, v):
        return jnp.sum(j_layers.chunked_attention(q, k, v, **kw) * w)

    want = j_layers.chunked_attention(q, k, v, **kw)
    got = t_layers.chunked_attention(_t(q), _t(k), _t(v), **kw)
    _close(got, want, LAYER_TOL)
    j_g = jax.grad(j_f, argnums=(0, 1, 2))(q, k, v)
    t_g = torch.func.grad(
        lambda q, k, v: torch.sum(t_layers.chunked_attention(q, k, v, **kw)
                                  * _t(w)), argnums=(0, 1, 2))(_t(q), _t(k), _t(v))
    for name, a, b in zip("qkv", t_g, j_g):
        _close(a, b, LAYER_TOL, f"d{name}")


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_jax(act):
    D, F = 24, 40
    p = {"w1": _normal(0, (D, F), 0.2), "w2": _normal(1, (F, D), 0.2),
         "w3": _normal(2, (D, F), 0.2)}
    if act == "gelu":
        p["b1"], p["b2"] = _normal(3, (F,)), _normal(4, (D,))
        del p["w3"]
    x = _normal(5, (2, 7, D))
    _close(t_layers.mlp(_t(x), {k: _t(v) for k, v in p.items()}, act),
           j_layers.mlp(x, p, act), LAYER_TOL)


# ------------------------------------------------------------- the model


def _model_inputs(arch, seed=0, B=2, S=12, **kw):
    jcfg, tcfg = _cfgs(arch, d_model=64, **kw)
    jp = j_tf.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = zoo_params_from_numpy(jax.tree.map(np.array, jp), device="cpu")
    toks = _rng(seed).integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    return jcfg, tcfg, jp, tp, batch


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(arch):
    jcfg, tcfg, jp, tp, batch = _model_inputs(arch)
    want, _ = j_tf.forward(jp, batch["tokens"], jcfg)
    got, aux = t_tf.forward(tp, _t(batch["tokens"]), tcfg)
    assert got.shape == (2, 12, jcfg.vocab_size) and float(aux) == 0.0
    _close_model(got, want)


def test_forward_sliding_window_matches_jax():
    """A dense arch with a sliding window (the JAX package's long-decode
    variant, ``for_shape``), in train mode."""
    import dataclasses
    jcfg, tcfg, jp, tp, batch = _model_inputs("qwen3-0.6b", S=16)
    jcfg = dataclasses.replace(jcfg, sliding_window=5)
    tcfg = dataclasses.replace(tcfg, sliding_window=5)
    want, _ = j_tf.forward(jp, batch["tokens"], jcfg)
    got, _ = t_tf.forward(tp, _t(batch["tokens"]), tcfg)
    _close_model(got, want)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-0.6b", "qwen2.5-32b",
                                  "codeqwen1.5-7b"])
def test_loss_and_grad_match_jax(arch):
    """``loss_fn`` and its gradient: tied embeddings (smollm, qwen3), qk-norm
    (qwen3), QKV bias with untied embeddings (qwen2.5, codeqwen)."""
    jcfg, tcfg, jp, tp, batch = _model_inputs(arch, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    j_loss, j_grad = jax.value_and_grad(j_tf.loss_fn)(jp, jb, jcfg)
    t_grad = torch.func.grad(lambda p: t_tf.loss_fn(p, tb, tcfg))(tp)
    _close_model(t_tf.loss_fn(tp, tb, tcfg), j_loss, "loss")
    want = zoo_params_from_numpy(jax.tree.map(np.array, j_grad), device="cpu")
    assert sorted(t_grad) == sorted(want)
    for k in want:
        _close_model(t_grad[k], want[k], k)


def test_loss_vmapped_over_workers_matches_one_at_a_time():
    """The per-worker gradient the drivers take (``vmap`` of ``grad``) gives
    each worker's own gradient."""
    _, tcfg, _, tp, _ = _model_inputs("smollm-360m")
    toks = torch.from_numpy(_rng(5).integers(0, 512, size=(3, 1, 8)))
    b = {"tokens": toks, "labels": torch.roll(toks, -1, 2)}

    def g(p, bb):
        return torch.func.grad(lambda q: t_tf.loss_fn(q, bb, tcfg))(p)

    batched = torch.func.vmap(g, in_dims=(None, 0))(tp, b)
    for w in range(3):
        one = g(tp, {k: v[w] for k, v in b.items()})
        for k in one:
            _close(batched[k][w], one[k], LAYER_TOL, k)


# ------------------------------------------------------------- the families


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_families_raise(arch):
    """Each non-dense family (they raised ``NotImplementedError`` before the
    port had them; the name is kept) now runs through ``init_params`` and
    ``make_zoo_task`` and matches JAX: its reduced model's logits and router
    aux on the JAX weights, within ``MODEL_TOL``'s scaled atol (3e-6 of the
    logits for the two scans, rwkv6 and jamba: ``tests/test_torch_
    families.py``'s ``SCAN_MODEL_TOL``), and one unit's gradient of its
    zoo task is finite over every leaf."""
    cfg = t_configs.get_reduced_config(arch)
    assert sorted(t_models.init_params(cfg, 0, device="cpu")) == sorted(
        _flat_jax(jax.eval_shape(lambda k: j_tf.init_params(
            j_configs.get_reduced_config(arch), k), jax.random.PRNGKey(0))))
    task, _ = t_models.make_zoo_task(arch, seq_len=8, device="cpu")
    b = {k: (v[0, 0] if isinstance(v, torch.Tensor) else
             {e: x[0, 0] for e, x in v.items()})
         for k, v in task.make_sampler(2)(0, 1).items()}
    g = task.grad_fn(task.params0, b)
    assert sorted(g) == sorted(task.params0)
    assert all(bool(torch.isfinite(v).all()) for v in g.values())
    jcfg, tcfg, jp, tp, batch = _model_inputs(arch)
    extra = None
    if jcfg.family == "audio":
        extra = {"frames": _normal(7, (2, jcfg.encoder_seq, 64))}
    elif jcfg.family == "vlm":
        extra = {"patches": _normal(7, (2, jcfg.n_image_tokens, 64))}
    want, j_aux = j_tf.forward(jp, batch["tokens"], jcfg, extra=extra)
    got, aux = t_tf.forward(tp, _t(batch["tokens"]), tcfg, extra=None if extra
                            is None else {k: _t(v) for k, v in extra.items()})
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    atol = 3e-6 if jcfg.family in ("ssm", "hybrid") else MODEL_TOL["atol"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=MODEL_TOL["rtol"], atol=atol * scale)
    _close(aux, j_aux, LAYER_TOL)


def _shapes(tree):
    """name -> (shape, dtype name) of every leaf of a flat cache or of a
    JAX cache tree."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tree.items()}
    return {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat_jax(tree).items()}


@pytest.mark.parametrize("entry", ["prefill", "decode_step", "init_cache",
                                   "forward_prefill", "forward_extra",
                                   "forward_remat"])
def test_serving_entry_points_raise(entry):
    """The serving entry points, once raising "The model zoo", now run and
    return the JAX package's structure: the same tuple, logits of the same
    shape and a cache with the JAX cache's leaf names, shapes and dtypes
    (``tests/test_torch_decode.py`` holds their values). The
    ``forward_extra`` case (it raised before the families were ported; the
    id is kept): a dense forward ignores ``extra``, as the JAX package's
    does. ``forward_remat`` (it raised ``NotImplementedError`` before the
    recompute was ported; the id is kept): ``forward(remat=True)`` runs in
    train mode, its logits, aux and gradient bitwise remat=False's
    (``tests/test_torch_remat.py`` holds every arch), and prefill mode
    ignores ``remat``."""
    jcfg, tcfg, jp, tp, batch = _model_inputs("smollm-360m")
    toks = _t(batch["tokens"])
    if entry == "forward_extra":
        plain = t_models.forward(tp, toks, tcfg)
        for extra in ({}, {"frames": torch.ones(2, 3, 64)}):
            got = t_models.forward(tp, toks, tcfg, extra=extra)
            assert all(torch.equal(a, b) for a, b in zip(got, plain))
        return
    if entry == "forward_remat":
        runs = [t_models.forward(tp, toks, tcfg, remat=r) for r in (True, False)]
        assert all(torch.equal(a, b) for a, b in zip(*runs))

        def grad_of(remat):
            return torch.func.grad(lambda p: t_models.forward(
                p, toks, tcfg, remat=remat)[0].square().mean())(tp)

        g_r, g_0 = grad_of(True), grad_of(False)
        assert all(torch.equal(g_r[k], g_0[k]) for k in g_0)
        pre = [t_models.forward(tp, toks, tcfg, mode="prefill", remat=r)
               for r in (True, False)]
        assert sorted(pre[0][2]) == ["b0/mix/k", "b0/mix/v"]
        assert all(torch.equal(a, b) for a, b in zip(pre[0][:2], pre[1][:2]))
        assert all(torch.equal(pre[0][2][k], pre[1][2][k]) for k in pre[1][2])
        return
    V, (B, S) = jcfg.vocab_size, batch["tokens"].shape
    if entry == "init_cache":
        got = t_models.init_cache(tcfg, B, 16, device="cpu")
        assert _shapes(got) == _shapes(j_tf.init_cache(jcfg, B, 16))
        return
    _, want = j_tf.prefill(jp, batch["tokens"], jcfg, pad_to=S + 2)
    if entry == "prefill":
        logits, cache = t_models.prefill(tp, toks, tcfg, pad_to=S + 2)
        assert logits.shape == (B, V) and _shapes(cache) == _shapes(want)
    elif entry == "forward_prefill":
        logits, aux, cache = t_models.forward(tp, toks, tcfg, mode="prefill",
                                              pad_to=S + 2)
        assert logits.shape == (B, S, V) and aux.shape == ()
        assert _shapes(cache) == _shapes(want)
    else:
        cache = t_models.prefill(tp, toks, tcfg, pad_to=S + 2)[1]
        logits, new = t_models.decode_step(tp, cache, toks[:, 0], S, tcfg)
        assert logits.shape == (B, V) and _shapes(new) == _shapes(want)


def test_models_exports_the_jax_packages_names():
    import repro.models
    assert set(repro.models.__all__) <= set(t_models.__all__)
