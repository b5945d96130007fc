"""The port's decode entry points (``init_cache``, ``prefill``,
``decode_step``, ``forward(mode="prefill")``, every mixer's cache branch,
``layers.decode_attention``, ``ssm.selective_step``, ``moe_ffn`` at S == 1)
against the JAX package's ``repro.models``, on the CPU, at reduced configs
(d_model 64, B=2, a prompt of S=9). Both packages get the same numpy
inputs; the JAX weights come across through ``convert.zoo_params_from_
numpy`` and its caches through ``convert.zoo_cache_from_numpy``. The JAX
side runs eagerly, without ``jax.jit``.

Tolerances: the layers at ``LAYER_TOL`` and the models (logits and
float32 cache leaves) at ``MODEL_TOL`` of ``tests/test_torch_models.py``,
its atol times the result's largest |value| and 3e-6 for the ssm and
hybrid families (their scans sum in another order,
``tests/test_torch_families.py``). A bfloat16 cache leaf is held to one
bfloat16 ulp of its largest |value|: a float32 value a rounding away from
a bfloat16 boundary may round to either side.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import layers as j_layers
from repro.models import moe as j_moe
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tf
from repro_torch import configs as t_configs
from repro_torch.convert import (
    zoo_cache_from_numpy, zoo_cache_to_numpy, zoo_params_from_numpy,
)
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_tf
from test_torch_models import LAYER_TOL, MODEL_TOL, _flat_jax

ARCHS = j_configs.ARCH_IDS
GREEDY = ["smollm-360m", "rwkv6-1.6b", "jamba-1.5-large-398b", "whisper-base"]
B, S = 2, 9
PAD = S + 4  # the prefill's pad_to


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=LAYER_TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=what,
                               **tol)


def _close_model(got, want, cfg, what=""):
    """``MODEL_TOL``, its atol times the result's largest |value| (3e-6 for
    the families with a scan)."""
    want = np.asarray(want)
    atol = 3e-6 if cfg.family in ("ssm", "hybrid") else MODEL_TOL["atol"]
    np.testing.assert_allclose(np.asarray(got), want, err_msg=what,
                               rtol=MODEL_TOL["rtol"],
                               atol=atol * max(1.0, float(np.abs(want).max())))


def _close_cache(got, want, cfg):
    """A port cache against a JAX cache tree: the same leaves and dtypes,
    float32 leaves at the model tolerance, bfloat16 ones within an ulp."""
    want = zoo_cache_from_numpy(_np(want), device="cpu")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        if w.dtype == torch.bfloat16:
            top = float(w.float().abs().max())
            ulp = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0
            _close(got[k].float(), w.float(), dict(rtol=0, atol=ulp), k)
        else:
            _close_model(got[k], w, cfg, k)


def _cfgs(arch, **kw):
    jcfg = j_configs.get_reduced_config(arch, d_model=64)
    tcfg = t_configs.get_reduced_config(arch, d_model=64)
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)


@functools.lru_cache(maxsize=None)
def _model(arch, seed=0, n_tok=S + 1, **kw):
    """(jcfg, tcfg, JAX params, port params, tokens (B, n_tok), extra as
    numpy, extra as tensors) of a reduced arch."""
    jcfg, tcfg = _cfgs(arch, **dict(kw))
    jp = j_tf.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = zoo_params_from_numpy(_np(jp), device="cpu")
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (B, n_tok)).astype(np.int32)
    extra = None
    if jcfg.family == "audio":
        extra = {"frames": _normal(seed + 7, (B, jcfg.encoder_seq, 64))}
    elif jcfg.family == "vlm":
        extra = {"patches": _normal(seed + 7, (B, jcfg.n_image_tokens, 64))}
    textra = None if extra is None else {k: _t(v) for k, v in extra.items()}
    return jcfg, tcfg, jp, tp, toks, extra, textra


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """The JAX package on ``_model(arch)``: prefill of S tokens (pad_to
    PAD), one decode step at pos S from its cache, and the full forward of
    the S + 1 tokens; numpy leaves."""
    jcfg, _, jp, _, toks, extra, _ = _model(arch)
    logits, cache = j_tf.prefill(jp, toks[:, :S], jcfg, extra=extra,
                                 pad_to=PAD)
    step, new = j_tf.decode_step(jp, cache, toks[:, S], jnp.int32(S), jcfg)
    full, _ = j_tf.forward(jp, toks, jcfg, extra=extra, remat=False)
    return _np(logits), _np(cache), _np(step), _np(new), _np(full)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch):
    """The last position's logits and every cache leaf (names, shapes,
    dtypes, values) of ``prefill(pad_to=)``."""
    _, tcfg, _, tp, toks, _, textra = _model(arch)
    want_logits, want_cache, *_ = _jax_run(arch)
    logits, cache = t_tf.prefill(tp, _t(toks[:, :S]), tcfg, extra=textra,
                                 pad_to=PAD)
    _close_model(logits, want_logits, tcfg, "logits")
    _close_cache(cache, want_cache, tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_from_jax_cache_matches_jax(arch):
    """One ``decode_step`` from the JAX prefill's cache, converted: its
    logits and its new cache against JAX's."""
    _, tcfg, _, tp, toks, _, _ = _model(arch)
    _, jcache, want, want_cache, _ = _jax_run(arch)
    cache = zoo_cache_from_numpy(jcache, device="cpu")
    logits, new = t_tf.decode_step(tp, cache, _t(toks[:, S]), S, tcfg)
    _close_model(logits, want, tcfg, "logits")
    _close_cache(new, want_cache, tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_jax(arch):
    """The port's own prefill and decode step against the JAX package's,
    and against JAX's full forward at position S as
    ``tests/test_models.py::test_arch_decode_matches_forward`` holds JAX's
    (a relative max error below 5e-3)."""
    _, tcfg, _, tp, toks, _, textra = _model(arch)
    _, _, want, want_cache, full = _jax_run(arch)
    cache = t_tf.prefill(tp, _t(toks[:, :S]), tcfg, extra=textra,
                         pad_to=PAD)[1]
    logits, new = t_tf.decode_step(tp, cache, _t(toks[:, S]),
                                   torch.tensor(S), tcfg)
    _close_model(logits, want, tcfg, "logits")
    _close_cache(new, want_cache, tcfg)
    rel = (np.abs(full[:, S] - logits.numpy()).max()
           / (np.abs(full[:, S]).max() + 1e-9))
    assert rel < 5e-3, rel


@pytest.mark.parametrize("shape", ["default", "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(arch, shape):
    """``init_cache``'s leaf names, shapes and dtypes (bfloat16 but the
    float32 ssm and wkv states) and zeros, against JAX's, at the reduced
    config and at its ``for_shape(SHAPES["decode_32k"])`` variant, as
    ``tests/test_models.py::test_arch_init_cache_structure`` builds it."""
    jcfg = j_configs.reduced(j_configs.get_config(arch))
    tcfg = t_configs.reduced(t_configs.get_config(arch))
    if shape != "default":
        jcfg = jcfg.for_shape(j_configs.SHAPES[shape])
        tcfg = tcfg.for_shape(t_configs.SHAPES[shape])
    want = zoo_cache_from_numpy(_np(j_tf.init_cache(jcfg, 2, 64)), device="cpu")
    got = t_tf.init_cache(tcfg, 2, 64, device="cpu")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].shape[0] == tcfg.n_groups and not got[k].any(), k
    f32 = t_tf.init_cache(tcfg, 2, 64, dtype=torch.float32, device="cpu")
    assert all(v.dtype == torch.float32 for v in f32.values())


def _greedy_jax(jcfg, jp, toks, extra, n_new, pad_to):
    logits, cache = j_tf.prefill(jp, toks, jcfg, extra=extra, pad_to=pad_to)
    out, steps = [np.asarray(jnp.argmax(logits, -1))], [np.asarray(logits)]
    for i in range(n_new - 1):
        logits, cache = j_tf.decode_step(jp, cache, jnp.asarray(out[-1]),
                                         jnp.int32(toks.shape[1] + i), jcfg)
        out.append(np.asarray(jnp.argmax(logits, -1)))
        steps.append(np.asarray(logits))
    return np.stack(out, 1), steps


def _greedy(tcfg, tp, toks, extra, n_new, pad_to):
    logits, cache = t_tf.prefill(tp, toks, tcfg, extra=extra, pad_to=pad_to)
    out, steps = [logits.argmax(-1)], [logits]
    pos = torch.tensor(toks.shape[1])
    for _ in range(n_new - 1):
        logits, cache = t_tf.decode_step(tp, cache, out[-1], pos, tcfg)
        out.append(logits.argmax(-1))
        steps.append(logits)
        pos = pos + 1
    return torch.stack(out, 1), steps


@pytest.mark.parametrize("arch", GREEDY)
def test_greedy_generation_matches_jax(arch):
    """Greedy decoding, B=2, a prompt of 7 tokens, 4 new tokens (the
    prefill's and 3 decode steps'): the tokens equal JAX's and each step's
    logits within the model tolerance."""
    jcfg, tcfg, jp, tp, toks, extra, textra = _model(arch)
    want, want_logits = _greedy_jax(jcfg, jp, toks[:, :7], extra, 4, 12)
    got, logits = _greedy(tcfg, tp, _t(toks[:, :7]), textra, 4, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    for i, (g, w) in enumerate(zip(logits, want_logits)):
        _close_model(g, w, tcfg, f"step {i}")


def test_decode_wraps_past_the_padded_cache_like_jax():
    """Decoding past a ``pad_to`` cache: a prompt of 5, pad_to 7 and 5
    decode steps (positions 5..9) write slots 5, 6, 0, 1, 2 of the ring;
    every step's logits and the last cache against JAX's."""
    jcfg, tcfg, jp, tp, toks, _, _ = _model("smollm-360m")
    jl, jc = j_tf.prefill(jp, toks[:, :5], jcfg, pad_to=7)
    tl, tc = t_tf.prefill(tp, _t(toks[:, :5]), tcfg, pad_to=7)
    _close_model(tl, jl, tcfg, "prefill")
    for pos in range(5, 10):
        tok = toks[:, pos]
        jl, jc = j_tf.decode_step(jp, jc, tok, jnp.int32(pos), jcfg)
        tl, tc = t_tf.decode_step(tp, tc, _t(tok), pos, tcfg)
        _close_model(tl, jl, tcfg, f"pos {pos}")
    assert tc["b0/mix/k"].shape[2] == 7
    _close_cache(tc, jc, tcfg)


def test_sliding_window_prompt_a_multiple_of_the_window():
    """``sliding_window=4``, ``attn_impl="chunked"``, a prompt of S=8 (a
    multiple of the window): the windowed prefill cache holds positions
    4..7 in slots 0..3, where the ring puts them, so prefill + decode_step
    matches the port's own full forward at position 8, and JAX's."""
    jcfg, tcfg, jp, tp, toks, _, _ = _model(
        "smollm-360m", sliding_window=4, attn_impl="chunked")
    cache = t_tf.prefill(tp, _t(toks[:, :8]), tcfg)[1]
    assert cache["b0/mix/k"].shape[2] == 4
    logits, _ = t_tf.decode_step(tp, cache, _t(toks[:, 8]), 8, tcfg)
    full, _ = t_tf.forward(tp, _t(toks), tcfg)
    _close_model(logits, full[:, 8], tcfg, "port forward")
    want, _ = j_tf.decode_step(jp, j_tf.prefill(jp, toks[:, :8], jcfg)[1],
                               toks[:, 8], jnp.int32(8), jcfg)
    _close_model(logits, want, tcfg, "JAX")


def test_sliding_window_prompt_not_a_multiple_equals_jax():
    """``sliding_window=4`` at S=6. The JAX package's decode maps position p
    to slot p % W (reference ``models/transformer.py:235``), while its
    prefill keeps ``k[:, -W:]`` (positions 2..5) in slots 0..3 (:259-262):
    the two layouts agree only when S is a multiple of W, so here its
    decode step overwrites position 2's slot with position 6's keys and
    reads position 4's keys at position 6's place (on these inputs, JAX's
    logits are 0.77 of their largest |value| off its full forward's, and
    5.3e-7 at S=8; ROADMAP.md §3). The port keeps the reference's layout: it
    equals JAX's step and cache, and agreement with the full forward is not
    asserted."""
    jcfg, tcfg, jp, tp, toks, _, _ = _model(
        "smollm-360m", sliding_window=4, attn_impl="chunked")
    jl, jc = j_tf.prefill(jp, toks[:, :6], jcfg)
    want, want_cache = j_tf.decode_step(jp, jc, toks[:, 6], jnp.int32(6), jcfg)
    cache = t_tf.prefill(tp, _t(toks[:, :6]), tcfg)[1]
    _close_cache(cache, jc, tcfg)
    logits, new = t_tf.decode_step(tp, cache, _t(toks[:, 6]), 6, tcfg)
    _close_model(logits, want, tcfg, "logits")
    _close_cache(new, want_cache, tcfg)


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-1.6b",
                                  "jamba-1.5-large-398b", "whisper-base"])
def test_decode_from_a_bfloat16_cache_matches_jax(arch):
    """The JAX prefill's cache cast to bfloat16, as ``init_cache`` would hold
    it: the step casts the new k/v to bfloat16 and reads Mamba's conv
    state and RWKV's prev in the compute dtype (float32), so the new
    cache's attention leaves stay bfloat16 and the others come out float32,
    as in the JAX package."""
    jcfg, tcfg, jp, tp, toks, _, _ = _model(arch)
    jcache = jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key in ("ssm", "state")
        else jnp.asarray(a, jnp.bfloat16), _jax_run(arch)[1])
    want, want_cache = j_tf.decode_step(jp, jcache, toks[:, S], jnp.int32(S),
                                        jcfg)
    cache = zoo_cache_from_numpy(_np(jcache), device="cpu")
    logits, new = t_tf.decode_step(tp, cache, _t(toks[:, S]), S, tcfg)
    _close_model(logits, want, tcfg, "logits")
    _close_cache(new, want_cache, tcfg)
    assert any(v.dtype == torch.bfloat16 for v in new.values()) == (
        tcfg.family != "ssm")


def test_mamba_prefill_cache_pads_a_short_prompt():
    """Jamba's Mamba conv state after a prompt of 2 tokens, shorter than
    mamba_conv - 1 = 3: left-padded with zeros, against JAX's; and a
    decode step from it."""
    jcfg, tcfg, jp, tp, toks, _, _ = _model("jamba-1.5-large-398b")
    jl, jc = j_tf.prefill(jp, toks[:, :2], jcfg, pad_to=4)
    tl, tc = t_tf.prefill(tp, _t(toks[:, :2]), tcfg, pad_to=4)
    _close_model(tl, jl, tcfg, "logits")
    _close_cache(tc, jc, tcfg)
    assert not tc["b0/mix/conv"][:, :, 0].any()
    want, _ = j_tf.decode_step(jp, jc, toks[:, 2], jnp.int32(2), jcfg)
    got, _ = t_tf.decode_step(tp, tc, _t(toks[:, 2]), 2, tcfg)
    _close_model(got, want, tcfg, "decode")


@pytest.mark.parametrize("arch", ["smollm-360m", "jamba-1.5-large-398b",
                                  "rwkv6-1.6b"])
def test_decode_step_leaves_its_cache_unmodified(arch):
    """``decode_step`` returns a new cache and leaves its argument's every
    leaf as it was; a tensor ``pos`` gives the int's bits; no autograd
    graph is recorded, even for params that require a gradient."""
    _, tcfg, _, tp, toks, _, _ = _model(arch)
    tp = {k: v.clone().requires_grad_(v.is_floating_point())
          for k, v in tp.items()}
    logits0, cache = t_tf.prefill(tp, _t(toks[:, :S]), tcfg, pad_to=PAD)
    before = {k: v.clone() for k, v in cache.items()}
    logits, new = t_tf.decode_step(tp, cache, _t(toks[:, S]), S, tcfg)
    again, _ = t_tf.decode_step(tp, cache, _t(toks[:, S]),
                                torch.tensor(S, dtype=torch.int32), tcfg)
    assert all(torch.equal(cache[k], before[k]) for k in cache)
    assert all(not torch.equal(new[k], cache[k]) for k in cache
               if k.endswith(("mix/k", "mix/v", "state", "ssm")))
    assert torch.equal(logits, again)
    assert not (logits0.requires_grad or logits.requires_grad
                or any(v.requires_grad for v in new.values()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_converter_round_trip(dtype):
    """A JAX cache tree -> the port's flat cache -> a JAX tree again: the
    same names, dtypes and bits; ``init_cache`` (bfloat16 with float32
    states) and a prefill's float32 cache; whisper's and jamba's."""
    for arch in ("whisper-base", "jamba-1.5-large-398b"):
        jcfg = _model(arch)[0]
        tree = (_np(j_tf.init_cache(jcfg, B, 8)) if dtype == "bfloat16"
                else _jax_run(arch)[1])
        cache = zoo_cache_from_numpy(tree, device="cpu")
        back = zoo_cache_to_numpy(cache)
        flat_a, flat_b = (jax.tree_util.tree_flatten_with_path(t)[0]
                          for t in (tree, back))
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
        for (path, a), (_, b) in zip(flat_a, flat_b):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert a.tobytes() == b.tobytes(), path
        assert sorted(cache) == sorted(t_tf.init_cache(
            _model(arch)[1], B, 8, device="cpu"))


# ------------------------------------------------------------- the layers


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(dtype, masked):
    """One query against a cache (GQA, H=4 over KV=2), f32 or bfloat16 k/v,
    with and without a length mask (at least one valid slot a row)."""
    q = _normal(0, (3, 1, 4, 8))
    k, v = _normal(1, (3, 6, 2, 8)), _normal(2, (3, 6, 2, 8))
    mask = None
    if masked:
        mask = np.random.default_rng(3).random((3, 6)) < 0.6
        mask[:, 0] = True
    jk, jv = jnp.asarray(k, dtype), jnp.asarray(v, dtype)
    want = j_layers.decode_attention(jnp.asarray(q), jk, jv, mask)
    tk, tv = (zoo_cache_from_numpy({"a": np.asarray(a)}, device="cpu")["a"]
              for a in (jk, jv))
    got = t_layers.decode_attention(_t(q), tk, tv,
                                    None if mask is None else _t(mask))
    assert got.dtype == torch.float32
    _close(got, want)


def test_selective_step_matches_jax():
    di, ds = 16, 4
    x, delta = _normal(0, (3, di)), np.abs(_normal(1, (3, di))) * 0.1
    A = -np.exp(_normal(2, (di, ds)) * 0.1)
    Bm, Cm, D, h = (_normal(3, (3, ds)), _normal(4, (3, ds)),
                    _normal(5, (di,)), _normal(6, (3, di, ds)))
    want = j_ssm.selective_step(x, delta, A, Bm, Cm, D, h)
    got = t_ssm.selective_step(*map(_t, (x, delta, A, Bm, Cm, D, h)))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("mixer", ["mamba", "rwkv_time", "rwkv_channel"])
def test_mixer_decode_matches_jax(mixer):
    """One mixer's decode step from a cache whose conv state / prev is
    bfloat16 (``init_cache``'s dtype) and whose ssm / wkv state is float32:
    its output and its new cache."""
    arch = "jamba-1.5-large-398b" if mixer == "mamba" else "rwkv6-1.6b"
    jcfg, tcfg, jp, tp, *_ = _model(arch)
    pre = {"mamba": "blocks/b0/mix/", "rwkv_time": "blocks/b0/mix/",
           "rwkv_channel": "blocks/b0/mlp/"}[mixer]
    jpar = {k[len(pre):]: v[0] for k, v in _flat_jax(jp).items()
            if k.startswith(pre)}
    tpar = {k[len(pre):]: v[0] for k, v in tp.items() if k.startswith(pre)}
    D = jcfg.d_model
    x = _normal(0, (B, 1, D))
    if mixer == "mamba":
        di = jcfg.mamba_expand * D
        cache = {"conv": _normal(1, (B, jcfg.mamba_conv - 1, di)),
                 "ssm": _normal(2, (B, di, jcfg.mamba_d_state))}
        jfn = lambda c: j_ssm.mamba_mixer(x, jpar, jcfg, cache=c)
        tfn = lambda c: t_ssm.mamba_mixer(_t(x), tpar, tcfg, cache=c)
        low = "conv"
    else:
        H, hd = D // jcfg.rwkv_head_dim, jcfg.rwkv_head_dim
        cache = {"prev": _normal(1, (B, D))}
        if mixer == "rwkv_time":
            cache["state"] = _normal(2, (B, H, hd, hd))
            jfn = lambda c: j_ssm.rwkv_time_mix(x, jpar, jcfg, cache=c)
            tfn = lambda c: t_ssm.rwkv_time_mix(_t(x), tpar, tcfg, cache=c)
        else:
            jfn = lambda c: j_ssm.rwkv_channel_mix(x, jpar, cache=c)
            tfn = lambda c: t_ssm.rwkv_channel_mix(_t(x), tpar, cache=c)
        low = "prev"
    jcache = {k: jnp.asarray(v, jnp.bfloat16) if k == low else jnp.asarray(v)
              for k, v in cache.items()}
    want, want_new = jfn(jcache)
    got, new = tfn(zoo_cache_from_numpy(_np(jcache), device="cpu"))
    _close(got, want)
    assert sorted(new) == sorted(want_new)
    for k in new:
        assert str(new[k].dtype).split(".")[-1] == str(want_new[k].dtype), k
        _close(new[k], want_new[k], what=k)


@pytest.mark.parametrize("router", ["random", "tied"])
@pytest.mark.parametrize("token_group", [0, 2])
def test_moe_ffn_decode_matches_jax(router, token_group):
    """``moe_ffn`` at S == 1: its B tokens routed as one group at capacity B
    (no token dropped, ``token_group`` ignored), against JAX's; a zero
    router (every probability tied) picks the lower expert indices, as
    ``jax.lax.top_k`` does."""
    E, D, Fd = 4, 16, 24
    p = {"router": _normal(0, (D, E)) * (router == "random"),
         "we1": _normal(1, (E, D, Fd), 0.2), "we2": _normal(2, (E, Fd, D), 0.2),
         "we3": _normal(3, (E, D, Fd), 0.2)}
    x = _normal(4, (5, 1, D))
    kw = dict(top_k=2, capacity_factor=0.5, act="swiglu",
              token_group=token_group)
    want, want_aux = j_moe.moe_ffn(jnp.asarray(x), p, **kw)
    got, aux = t_moe.moe_ffn(_t(x), {k: _t(v) for k, v in p.items()}, **kw)
    _close(got, want)
    _close(aux, want_aux)
