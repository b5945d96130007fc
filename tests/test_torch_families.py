"""The model zoo's non-dense families in the port (audio, VLM, MoE, SSM,
hybrid) against the JAX package, on the CPU, at reduced configs (d_model
64): ``layers.group_norm_heads``, ``models/moe.py``, ``models/ssm.py``'s
train half, the audio encoder, every non-dense architecture's parameter
tree, forward pass, loss and gradient, the zoo's ``extra`` inputs, and T=8
replays of the JAX zoo driver (``microbatch=True``) for whisper-base and
qwen2-moe-a2.7b. Both packages get the same numpy inputs; the JAX weights
come across through ``convert.zoo_params_from_numpy``.

Tolerances, float32 throughout: the layers at ``LAYER_TOL`` and the models
at ``MODEL_TOL`` (its atol scaled by the result's largest |value|) of
``tests/test_torch_models.py``; the replays at ``tests/test_torch_zoo.py``'s
``TOL`` a leaf. The two scans need more, and say so where they are used:
``selective_scan``'s log-depth prefix scan pairs the steps in another tree
than JAX's ``associative_scan`` (``test_selective_scan_matches_jax``), and
the models with a scan (rwkv6, jamba) take ``SCAN_MODEL_TOL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.core import mlmc as j_mlmc
from repro.core import robust_train as j_rt
from repro.core import switching as j_switching
from repro.models import layers as j_layers
from repro.models import moe as j_moe
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tf
from repro.models import zoo as j_zoo
from repro.optim import optimizers as j_optim
from repro_torch import configs as t_configs
from repro_torch.convert import zoo_params_from_numpy, zoo_params_to_numpy
from repro_torch.core import mlmc as t_mlmc
from repro_torch.core import robust_train as t_rt
from repro_torch.core import switching as t_switching
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_tf
from repro_torch.models import zoo as t_zoo
from repro_torch.optim import optimizers as t_optim
from test_torch_models import LAYER_TOL, MODEL_TOL
from test_torch_zoo import TOL

NONDENSE = [a for a in j_configs.ARCH_IDS
            if j_configs.get_config(a).family != "dense"]
# The models with a scan, against the JAX package: the logits at atol 3e-6
# and the gradient at atol 3e-5, each times the result's largest |value|
# (rtol 1e-4). RWKV's first position has a wkv output of exactly 0 at
# initialisation (u = 0), so its per-head groupnorm multiplies that row's
# gradient by 1/√eps ≈ 316: float32 rounding upstream reaches the
# gradient magnified (measured against a float64 run of the port on the
# loss test's inputs, JAX's own u-gradient is off by 1.9e-4 of its largest
# 16.3, the port's by 4.0e-4; the port's embedding gradient by 6.2e-5 of
# 6.1, JAX's by 5.6e-6). Jamba's Mamba layers scan in another tree than
# JAX's (``test_selective_scan_matches_jax``); measured: logits 4.8e-6 of
# 4.2, gradient 2.5e-6 of 1.
SCAN_MODEL_TOL = {"rwkv6-1.6b": (3e-6, 3e-5),
                  "jamba-1.5-large-398b": (3e-6, 3e-5)}


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=LAYER_TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=what,
                               **tol)


def _close_model(got, want, what="", atol=MODEL_TOL["atol"]):
    """``MODEL_TOL`` with its atol scaled by the result's magnitude."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, err_msg=what,
                               rtol=MODEL_TOL["rtol"], atol=atol * scale)


def _cfgs(arch, **kw):
    return (j_configs.get_reduced_config(arch, **kw),
            t_configs.get_reduced_config(arch, **kw))


def _flat_jax(tree):
    return {"/".join(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch_tree(tree):
    return {k: _t(v) for k, v in tree.items()}


# ------------------------------------------------------------- the layers


def test_group_norm_heads_matches_jax():
    x, s = _normal(0, (2, 5, 4, 16), 3.0), _normal(1, (4, 16))
    _close(t_layers.group_norm_heads(_t(x), _t(s)),
           j_layers.group_norm_heads(x, s))
    _close(t_layers.group_norm_heads(_t(x), _t(s), eps=1e-2),
           j_layers.group_norm_heads(x, s, eps=1e-2))


# ------------------------------------------------------------- the MoE FFN


def test_capacity_is_the_jax_packages():
    for args in [(10, 1, 0.3, 1), (24, 2, 0.25, 4), (128, 2, 2.0, 4),
                 (4096, 4, 1.25, 60), (3, 1, 0.1, 8)]:
        assert t_moe._capacity(*args) == j_moe._capacity(*args), args


def _moe_params(seed, D=16, Fd=24, E=4, act="swiglu"):
    p = {"router": _normal(seed, (D, E), 0.5),
         "we1": _normal(seed + 1, (E, D, Fd), D ** -0.5),
         "we2": _normal(seed + 2, (E, Fd, D), Fd ** -0.5)}
    if act == "swiglu":
        p["we3"] = _normal(seed + 3, (E, D, Fd), D ** -0.5)
    return p


def test_topk_dispatch_ties_pick_the_lower_expert():
    """Uniform probabilities: every expert ties, and both packages route to
    the lowest indices (a stable descending sort, as ``lax.top_k``): the
    same dispatch and combine; the aux within ``LAYER_TOL``."""
    probs = np.full((6, 5), 0.2, np.float32)
    probs[3, 4] = 0.5  # one clear winner
    for top_k, cap in ((2, 3), (3, 6), (1, 1)):
        want = j_moe._topk_dispatch(jnp.asarray(probs), top_k, cap)
        got = t_moe._topk_dispatch(_t(probs), top_k, cap)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        _close(got[2], want[2])


@pytest.mark.parametrize("case", [
    ("swiglu", 2.0, 0), ("swiglu", 0.25, 0), ("gelu", 0.5, 0),
    ("swiglu", 0.5, 8), ("gelu", 2.0, 6)],
    ids=["swiglu-room", "swiglu-drops", "gelu-drops", "swiglu-groups8",
         "gelu-groups6"])
def test_moe_ffn_matches_jax(case):
    """``moe_ffn``'s output, aux and gradient (x and every weight): with room
    for every token, with drops at a tiny capacity (0.25: 3 slots an expert
    for 24 tokens at top-2), and routed in token groups."""
    act, factor, group = case
    p = _moe_params(0, act=act)
    x = _normal(9, (2, 12, 16))
    kw = dict(top_k=2, capacity_factor=factor, act=act, token_group=group)
    jo, ja = j_moe.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, p), **kw)
    to, ta = t_moe.moe_ffn(_t(x), _torch_tree(p), **kw)
    _close(to, jo)
    _close(ta, ja)
    w = _normal(10, x.shape)

    def j_f(x, p):
        o, a = j_moe.moe_ffn(x, p, **kw)
        return jnp.sum(o * w) + a

    def t_f(x, p):
        o, a = t_moe.moe_ffn(x, p, **kw)
        return torch.sum(o * _t(w)) + a

    jg = jax.grad(j_f, argnums=(0, 1))(jnp.asarray(x),
                                      jax.tree.map(jnp.asarray, p))
    tg = torch.func.grad(t_f, argnums=(0, 1))(_t(x), _torch_tree(p))
    _close(tg[0], jg[0], what="dx")
    for k in p:
        _close(tg[1][k], jg[1][k], what=k)


def test_moe_ffn_drops_tokens_at_tiny_capacity():
    """The drop case really drops: some token reaches fewer than top_k
    slots, the same ones in both packages."""
    probs = jax.nn.softmax(jnp.asarray(_normal(4, (24, 4)) * 3), -1)
    jd, _, _ = j_moe._topk_dispatch(probs, 2, 3)
    td, _, _ = t_moe._topk_dispatch(_t(probs), 2, 3)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert float(td.sum()) < 48


def test_moe_unported_branches_raise():
    """The branches that raised before they were ported (the name is
    kept): the decode branch (S == 1) routes its tokens as JAX's does, at
    capacity B (``tests/test_torch_decode.py`` holds it in full), and
    ``expert_shard``, a placement with no effect on the values, gives the
    output and aux of JAX's with it set, bitwise those without it."""
    p = _torch_tree(_moe_params(0))
    x = _normal(9, (2, 1, 16))
    want, want_aux = j_moe.moe_ffn(jnp.asarray(x), _moe_params(0),
                                   top_k=2, capacity_factor=1.0)
    got, aux = t_moe.moe_ffn(_t(x), p, top_k=2, capacity_factor=1.0)
    _close(got, want)
    _close(aux, want_aux)
    x = _normal(10, (2, 4, 16))
    want, want_aux = j_moe.moe_ffn(jnp.asarray(x), _moe_params(0), top_k=2,
                                   capacity_factor=1.0, expert_shard="data")
    plain = t_moe.moe_ffn(_t(x), p, top_k=2, capacity_factor=1.0)
    got, aux = t_moe.moe_ffn(_t(x), p, top_k=2, capacity_factor=1.0,
                             expert_shard="data")
    assert torch.equal(got, plain[0]) and torch.equal(aux, plain[1])
    _close(got, want)
    _close(aux, want_aux)


# ------------------------------------------------------------- Mamba


def _scan_inputs(L, Bt=2, di=6, ds=4):
    return dict(
        x=_normal(0, (Bt, L, di)),
        delta=np.log1p(np.exp(_normal(1, (Bt, L, di)))).astype(np.float32),
        A=-np.exp(_normal(2, (di, ds), 0.5)).astype(np.float32),
        B=_normal(3, (Bt, L, ds)), C=_normal(4, (Bt, L, ds)),
        D=_normal(5, (di,)))


@pytest.mark.parametrize("L,chunk", [(16, 256), (20, 8), (7, 4), (1, 256)])
def test_selective_scan_matches_jax(L, chunk):
    """One chunk, several (the last one short: JAX pads it), and one step;
    y, the last state and the gradient of a weighted sum of y. Tolerance
    rtol 1e-5, atol 2e-6: the port's Hillis-Steele prefix scan and JAX's
    ``associative_scan`` compose the decays in other trees (at most a few
    float32 ulps a product of up to L factors)."""
    a = _scan_inputs(L)
    tol = dict(rtol=1e-5, atol=2e-6)
    jy, jh = j_ssm.selective_scan(**{k: jnp.asarray(v) for k, v in a.items()},
                                  chunk=chunk)
    ty, th = t_ssm.selective_scan(**_torch_tree(a), chunk=chunk)
    _close(ty, jy, tol, "y")
    _close(th, jh, tol, "h_last")
    w = _normal(6, a["x"].shape)
    names = ("x", "delta", "B", "C", "D")

    def j_f(*args):
        kw = dict(a, **dict(zip(names, args)))
        return jnp.sum(j_ssm.selective_scan(**kw, chunk=chunk)[0] * w)

    def t_f(*args):
        kw = dict(_torch_tree(a), **dict(zip(names, args)))
        return torch.sum(t_ssm.selective_scan(**kw, chunk=chunk)[0] * _t(w))

    jg = jax.grad(j_f, argnums=tuple(range(5)))(
        *(jnp.asarray(a[n]) for n in names))
    tg = torch.func.grad(t_f, argnums=tuple(range(5)))(*(_t(a[n]) for n in names))
    for n, x, y in zip(names, tg, jg):
        _close(x, y, tol, f"d{n}")


def test_causal_conv_matches_jax():
    x, w, b = _normal(0, (2, 9, 6)), _normal(1, (4, 6)), _normal(2, (6,))
    _close(t_ssm._causal_conv(_t(x), _t(w), _t(b)),
           j_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


def _block_params(arch, prefix, seed=0):
    """One layer's leaves under ``prefix`` of a reduced arch's JAX tree, as
    numpy; constants replaced by draws so every term is exercised."""
    jcfg, tcfg = _cfgs(arch, d_model=64)
    flat = _flat_jax(jax.tree.map(np.asarray, j_tf.init_params(
        jcfg, jax.random.PRNGKey(seed))))
    p = {k[len(prefix):]: v[0] for k, v in flat.items() if k.startswith(prefix)}
    for i, k in enumerate(sorted(p)):
        if k.startswith("mu_") or k in ("u", "w0", "ln_x", "conv_b"):
            p[k] = _normal(100 + i, p[k].shape, 0.5) + (
                1.0 if k == "ln_x" else 0.0)
    return jcfg, tcfg, p


def _nested(flat):
    out = {}
    for k, v in flat.items():
        *path, name = k.split("/")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[name] = jnp.asarray(v)
    return out


def test_mamba_mixer_matches_jax():
    """Jamba's reduced Mamba layer (d_inner 128, d_state 8, conv 4), its
    output and prefill cache, and the gradient of its output."""
    jcfg, tcfg, p = _block_params("jamba-1.5-large-398b", "blocks/b0/mix/")
    x = _normal(7, (2, 10, 64))
    jy, jc = j_ssm.mamba_mixer(jnp.asarray(x), _nested(p), jcfg)
    ty, tc = t_ssm.mamba_mixer(_t(x), _torch_tree(p), tcfg)
    _close(ty, jy, dict(rtol=1e-5, atol=2e-6))
    _close(tc["conv"], jc["conv"])
    _close(tc["ssm"], jc["ssm"], dict(rtol=1e-5, atol=2e-6))
    w = _normal(8, jy.shape)
    jg = jax.grad(lambda p: jnp.sum(j_ssm.mamba_mixer(
        jnp.asarray(x), p, jcfg)[0] * w))(_nested(p))
    tg = torch.func.grad(lambda p: torch.sum(t_ssm.mamba_mixer(
        _t(x), p, tcfg)[0] * _t(w)))(_torch_tree(p))
    for k, v in _flat_jax(jg).items():
        _close_model(tg[k], v, k)
    # the decode branch, once raising: one token from the prefill cache
    x1 = _normal(9, (2, 1, 64))
    jy, jc = j_ssm.mamba_mixer(jnp.asarray(x1), _nested(p), jcfg, cache=jc)
    ty, tc = t_ssm.mamba_mixer(_t(x1), _torch_tree(p), tcfg, cache=tc)
    _close(ty, jy, dict(rtol=1e-5, atol=2e-6))
    _close(tc["conv"], jc["conv"])
    _close(tc["ssm"], jc["ssm"], dict(rtol=1e-5, atol=2e-6))


# ------------------------------------------------------------- RWKV-6


def test_rwkv_time_mix_matches_jax():
    """RWKV-6's reduced time mix (d_model 64, heads of 64): the decay, the
    sequential wkv scan, the per-head groupnorm, its prefill cache and the
    gradient of its output."""
    jcfg, tcfg, p = _block_params("rwkv6-1.6b", "blocks/b0/mix/")
    x = _normal(7, (2, 9, 64))
    _close(t_ssm._rwkv_decay(_t(x), _torch_tree(p)),
           j_ssm._rwkv_decay(jnp.asarray(x), _nested(p)))
    jy, jc = j_ssm.rwkv_time_mix(jnp.asarray(x), _nested(p), jcfg)
    ty, tc = t_ssm.rwkv_time_mix(_t(x), _torch_tree(p), tcfg)
    _close(ty, jy)
    _close(tc["prev"], jc["prev"])
    _close(tc["state"], jc["state"])
    w = _normal(8, jy.shape)
    jg = jax.grad(lambda p: jnp.sum(j_ssm.rwkv_time_mix(
        jnp.asarray(x), p, jcfg)[0] * w))(_nested(p))
    tg = torch.func.grad(lambda p: torch.sum(t_ssm.rwkv_time_mix(
        _t(x), p, tcfg)[0] * _t(w)))(_torch_tree(p))
    for k, v in _flat_jax(jg).items():
        _close_model(tg[k], v, k)
    # the decode branch, once raising: one token from the prefill cache
    x1 = _normal(9, (2, 1, 64))
    jy, jc = j_ssm.rwkv_time_mix(jnp.asarray(x1), _nested(p), jcfg, cache=jc)
    ty, tc = t_ssm.rwkv_time_mix(_t(x1), _torch_tree(p), tcfg, cache=tc)
    _close(ty, jy)
    _close(tc["prev"], jc["prev"])
    _close(tc["state"], jc["state"])


def test_rwkv_channel_mix_matches_jax():
    _, _, p = _block_params("rwkv6-1.6b", "blocks/b0/mlp/")
    x = _normal(7, (2, 9, 64))
    jy, jc = j_ssm.rwkv_channel_mix(jnp.asarray(x), _nested(p))
    ty, tc = t_ssm.rwkv_channel_mix(_t(x), _torch_tree(p))
    _close(ty, jy)
    _close(tc["prev"], jc["prev"])
    # the decode branch, once raising: one token from the prefill cache
    x1 = _normal(9, (2, 1, 64))
    jy, jc = j_ssm.rwkv_channel_mix(jnp.asarray(x1), _nested(p), cache=jc)
    ty, tc = t_ssm.rwkv_channel_mix(_t(x1), _torch_tree(p), cache=tc)
    _close(ty, jy)
    _close(tc["prev"], jc["prev"])


# ------------------------------------------------------------- the models


def _model_inputs(arch, seed=0, B=2, S=12):
    jcfg, tcfg = _cfgs(arch, d_model=64)
    jp = j_tf.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = zoo_params_from_numpy(jax.tree.map(np.array, jp), device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    if jcfg.family == "audio":
        batch["extra"] = {"frames": _normal(seed + 1, (B, jcfg.encoder_seq, 64))}
    if jcfg.family == "vlm":
        batch["extra"] = {"patches": _normal(seed + 1,
                                             (B, jcfg.n_image_tokens, 64))}
    return jcfg, tcfg, jp, tp, batch


def test_encoder_forward_matches_jax():
    """Whisper's encoder (reduced: 2 layers over 16 frames): sinusoidal
    positions, bidirectional attention, the dense MLP, the final norm."""
    jcfg, tcfg, jp, tp, batch = _model_inputs("whisper-base")
    frames = batch["extra"]["frames"]
    _close_model(t_tf._encoder_forward(tp, _t(frames), tcfg),
                 j_tf._encoder_forward(jp, jnp.asarray(frames), jcfg))
    # whisper-base's own positions: 1500 frames of 512
    _close(t_tf._sinusoids(1500, 512, "cpu"), _jax_sinusoids(1500, 512))


def _jax_sinusoids(S, D):
    """The JAX package's encoder positions (``_encoder_forward``'s first
    lines)."""
    pos = jnp.arange(S)[:, None]
    dim = jnp.arange(D // 2)[None, :]
    ang = pos / (10000 ** (2 * dim / D))
    return jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], axis=-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NONDENSE)
def test_init_params_tree_is_the_jax_packages(arch, dtype):
    """Leaf names, shapes and dtypes of every non-dense arch, reduced; the
    constant leaves (norm scales, biases, Mamba's dt_bias, A_log and D,
    RWKV's mu, w0, u and ln_x) equal the JAX package's, A_log (a float32
    log) within ``LAYER_TOL``; the draws' scales match."""
    jcfg, tcfg = _cfgs(arch, d_model=64)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jp = _flat_jax(j_tf.init_params(jcfg, jax.random.PRNGKey(0), jd))
    got = t_tf.init_params(tcfg, 0, td, device="cpu")
    assert sorted(got) == sorted(jp)
    specs = t_tf._leaf_specs(tcfg, td)
    for k, want in jp.items():
        assert tuple(got[k].shape) == want.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(want.dtype), k
        w = np.asarray(want, np.float32)
        g = got[k].float().numpy()
        init = specs[k][1]
        if init == "alog":
            _close(g, w, what=k)
        elif init in ("ones", "zeros") or init[0] == "full":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert abs(g.std() - w.std()) <= 0.1 * w.std() + 1e-7, (k, g.std(),
                                                                  w.std())


@pytest.mark.parametrize("arch", NONDENSE)
def test_forward_matches_jax(arch):
    """Logits and the router aux (MoE and hybrid) of every non-dense arch,
    reduced, with its ``extra`` inputs."""
    jcfg, tcfg, jp, tp, batch = _model_inputs(arch)
    jx = jax.tree.map(jnp.asarray, batch.get("extra"))
    tx = jax.tree.map(_t, batch.get("extra"))
    want, jaux = j_tf.forward(jp, jnp.asarray(batch["tokens"]), jcfg, extra=jx)
    got, aux = t_tf.forward(tp, _t(batch["tokens"]), tcfg, extra=tx)
    assert got.shape == (2, 12, jcfg.vocab_size)
    _close_model(got, want, atol=SCAN_MODEL_TOL.get(arch, (1e-6,))[0])
    _close(aux, jaux)
    assert (float(aux) > 0) == jcfg.is_moe


@pytest.mark.parametrize("arch", NONDENSE)
def test_loss_and_grad_match_jax(arch):
    """``loss_fn`` (with the router aux) and its gradient, every leaf."""
    jcfg, tcfg, jp, tp, batch = _model_inputs(arch, seed=1)
    atol = SCAN_MODEL_TOL.get(arch, (None, MODEL_TOL["atol"]))[1]
    jb = jax.tree.map(jnp.asarray, batch)
    tb = jax.tree.map(_t, batch)
    j_loss, j_grad = jax.value_and_grad(j_tf.loss_fn)(jp, jb, jcfg)
    t_grad = torch.func.grad(lambda p: t_tf.loss_fn(p, tb, tcfg))(tp)
    _close_model(t_tf.loss_fn(tp, tb, tcfg), j_loss, "loss")
    want = zoo_params_from_numpy(jax.tree.map(np.array, j_grad), device="cpu")
    assert sorted(t_grad) == sorted(want)
    for k in want:
        _close_model(t_grad[k], want[k], k, atol)


def test_zoo_params_round_trip_over_the_largest_tree():
    """Jamba's tree (114 leaves at any width: a group of 7 Mamba layers
    and one attention layer, MoE on every other one) through
    ``zoo_params_from_numpy`` and back."""
    jcfg, _ = _cfgs("jamba-1.5-large-398b", d_model=32)
    tree = jax.tree.map(np.asarray, j_tf.init_params(jcfg,
                                                     jax.random.PRNGKey(1)))
    flat = zoo_params_from_numpy(tree, device="cpu")
    assert len(flat) == 114
    assert "blocks/b1/mlp/moe/we1" in flat and "blocks/b7/mix/wq" in flat
    back = zoo_params_to_numpy(flat)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    wb, _ = _cfgs("whisper-base", d_model=32)
    wtree = jax.tree.map(np.asarray, j_tf.init_params(wb, jax.random.PRNGKey(1)))
    wflat = zoo_params_from_numpy(wtree, device="cpu")
    assert len(wflat) == 33 and "encoder/blocks/mlp/dense/w1" in wflat
    assert wflat["encoder/blocks/attn/wq"].shape == (2, 32, 64)  # 2 x 32


# ------------------------------------------------------------- the zoo


@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-90b"])
def test_zoo_extra_units(arch):
    """The sampler's ``extra`` (frames or patches): (m, n, unit_batch, E,
    D) normals, a pure function of (seed, step, worker, unit), the level
    j−1 draw the prefix of the level-j one; the held-out batch has its own;
    a unit's gradient reads it."""
    task, cfg = t_zoo.make_zoo_task(arch, seq_len=8, d_model=32, unit_batch=2,
                                    device="cpu")
    name, E = (("frames", cfg.encoder_seq) if cfg.family == "audio"
               else ("patches", cfg.n_image_tokens))
    sample = task.make_sampler(3)
    b4, b2 = sample(5, 4), sample(5, 2)
    x = b4["extra"][name]
    assert x.shape == (3, 4, 2, E, 32) and x.dtype == torch.float32
    assert torch.equal(b2["extra"][name], x[:, :2])
    assert torch.equal(sample(5, 4)["extra"][name], x)
    assert not torch.equal(sample(6, 4)["extra"][name], x)
    assert not torch.equal(x[0, 0], x[1, 0]) and not torch.equal(x[0, 0], x[0, 1])
    assert abs(float(x.mean())) < 0.05 and abs(float(x.std()) - 1) < 0.05
    g = task.grad_fn(task.params0, jax.tree.map(lambda l: l[0, 0], b4))
    assert sorted(g) == sorted(task.params0)
    assert np.isfinite(task.objective(task.params0))
    other = t_zoo.make_zoo_task(arch, seq_len=8, d_model=32, unit_batch=2,
                                seed=1, device="cpu")[0]
    assert not torch.equal(other.make_sampler(3)(5, 4)["extra"][name], x)


def test_batch_schedule_carries_nested_extra():
    """``_batch_schedule`` stacks the rounds' nested ``extra`` with the
    tokens, each padded as ``_pad_units`` pads."""
    task, _ = t_zoo.make_zoo_task("whisper-base", seq_len=8, d_model=32,
                                  device="cpu")
    sample = task.make_sampler(2)
    tn = [(0, 1), (1, 4), (2, 2)]
    sched = t_rt._batch_schedule(sample, tn, 4)
    assert sched["extra"]["frames"].shape == (3, 2, 4, 1, 16, 32)
    for i, (t, n) in enumerate(tn):
        want = t_rt._pad_units(sample(t, n), 4, axis=1)
        for key in ("tokens", "labels"):
            assert torch.equal(sched[key][i], want[key])
        assert torch.equal(sched["extra"]["frames"][i], want["extra"]["frames"])


M, T, SEQ, D = 4, 8, 8, 32


def _dyn_cfg(pkg):
    mlmc, rt = (j_mlmc, j_rt) if pkg == "jax" else (t_mlmc, t_rt)
    return rt.DynaBROConfig(
        mlmc=mlmc.MLMCConfig(T=T, m=M, V=3.0, kappa=1.0, j_cap=2),
        aggregator="cwtm", delta=0.3, attack="sign_flip")


def _switcher(pkg):
    sw = j_switching if pkg == "jax" else t_switching
    return sw.get_switcher("periodic", M, n_byz=1, K=2)


def _jax_zoo_task(arch):
    """The JAX package's ``make_zoo_task(arch, seq_len=8, d_model=32)``
    pieces: params0, grad_fn and the sampler of (m, n) units with the
    family's ``extra``, built as its body builds them. ``make_zoo_task``
    itself raises for the audio and VLM families on this JAX version: its
    held-out batch folds the key with -1, which ``fold_in`` rejects
    (OverflowError, "out of bounds for uint32"); the training rounds never
    reach that line's key."""
    jcfg = j_configs.get_reduced_config(arch, d_model=D, n_layers=2)
    params0 = j_tf.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    data = j_zoo.SyntheticLMData(jcfg.vocab_size, SEQ, global_batch=1, seed=0)
    ekey = jax.random.PRNGKey(0 ^ 0x5EED)
    base = data.mlmc_sampler(M, 1)

    def sample(t, n):
        b = base(t, n)
        if jcfg.family in ("audio", "vlm"):
            b["extra"] = j_zoo._extra_units(jcfg, jax.random.fold_in(ekey, t),
                                            M, n, 1, jnp.float32)
        return b

    def grad_fn(params, b):
        return jax.grad(lambda p: j_tf.loss_fn(p, b, jcfg))(params)

    return params0, grad_fn, sample


@pytest.fixture(scope="module", params=["whisper-base", "qwen2-moe-a2.7b"])
def jax_replay(request):
    """The JAX package's zoo driver on ``arch`` reduced (d_model 32), T=8,
    microbatch=True, and the port's run of the same weights, batches (the
    ``extra`` frames included), levels and masks."""
    arch = request.param
    params0, grad_fn, jsample = _jax_zoo_task(arch)
    jp, jl, _ = j_rt.run_dynabro_scan(
        grad_fn, params0, j_optim.sgd(0.05), _dyn_cfg("jax"),
        _switcher("jax"), jsample, T, seed=3, microbatch=True)
    ttask = t_zoo.task_for_config(
        t_configs.get_reduced_config(arch, d_model=D, n_layers=2),
        seq_len=SEQ, device="cpu")

    def sample(t, n):
        return jax.tree.map(lambda v: torch.from_numpy(np.array(v)),
                            jsample(t, n))

    p0 = zoo_params_from_numpy(jax.tree.map(np.array, params0), "cpu")
    tp, tl, _ = t_rt.run_dynabro_scan(
        ttask.grad_fn, p0, t_optim.sgd(0.05), _dyn_cfg("torch"),
        _switcher("torch"), sample, T, seed=3, microbatch=True)
    want = zoo_params_from_numpy(jax.tree.map(np.array, jp), "cpu")
    return arch, (tp, tl), (want, jl)


def test_microbatch_replays_jax_round_logs(jax_replay):
    _, (_, tl), (_, jl) = jax_replay
    assert [vars(l) for l in tl] == [vars(l) for l in jl]
    assert {l.level for l in tl} >= {1, 3}  # in the cap and beyond it


# whisper-base's token embedding and decoder positions take atol 2e-6: their
# gradients reach |1.9| (every decoder position adds to them), which
# float32 rounds to within 1.1e-6 in both packages (measured against a
# float64 run of the port), and CWTM's trim can then keep another worker's
# value of a coordinate where two workers lie that close; measured 1.4e-6
# on 2 of dec_pos's 1,048,576 values after 8 rounds.
REPLAY_TOL = {("whisper-base", "embed"): dict(rtol=1e-5, atol=2e-6),
              ("whisper-base", "dec_pos"): dict(rtol=1e-5, atol=2e-6)}


def test_microbatch_replays_jax_every_leaf(jax_replay):
    arch, (tp, _), (want, _) = jax_replay
    assert sorted(tp) == sorted(want)
    assert len(want) == (33 if arch == "whisper-base" else 19)
    for k in want:
        np.testing.assert_allclose(tp[k].numpy(), want[k].numpy(), err_msg=k,
                                   **REPLAY_TOL.get((arch, k), TOL))
