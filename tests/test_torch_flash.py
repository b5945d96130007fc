"""The port's recomputing flash attention (``repro_torch.models.flash``)
against the JAX package's ``custom_vjp`` (``repro.models.flash``), on the
CPU, at small sizes: the forward and the vector-Jacobian product for q, k
and v, causal, windowed, GQA and cross (Skv ≠ Sq, keys padded to a
multiple of ``kv_chunk``); its vmap rule under ``torch.func.vmap(grad)``;
and ``attn_impl``'s dispatch in the transformer.

Tolerance: ``tests/test_torch_models.py``'s ``LAYER_TOL`` (rtol 1e-5, atol
1e-6), float32 throughout: the same formulas, summed in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import flash as j_flash
from repro.models import transformer as j_tf
from repro_torch import configs as t_configs
from repro_torch.convert import zoo_params_from_numpy
from repro_torch.models import flash as t_flash
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tf

LAYER_TOL = dict(rtol=1e-5, atol=1e-6)

# causal, window, q_offset, kv_chunk, Sq, Skv, H, KV
CASES = [
    (True, 0, 0, 1024, 16, 16, 4, 2),   # one chunk, GQA
    (True, 5, 0, 4, 13, 13, 4, 1),      # windowed, chunks padded, MQA
    (True, 3, 0, 4, 9, 9, 2, 2),        # a window narrower than a chunk
    (True, 0, 4, 8, 6, 10, 2, 1),       # queries at an offset
    (False, 0, 0, 5, 11, 17, 6, 3),     # cross: Skv != Sq, padded
    (False, 0, 0, 1024, 7, 16, 4, 4),   # cross, one chunk
]


def _ids(c):
    return "causal{}-w{}-off{}-kv{}-S{}x{}-H{}/{}".format(*c)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=what,
                               **LAYER_TOL)


def _inputs(case, hd=8):
    _, _, _, _, Sq, Skv, H, KV = case
    return (_normal(0, (2, Sq, H, hd)), _normal(1, (2, Skv, KV, hd)),
            _normal(2, (2, Skv, KV, hd)), _normal(3, (2, Sq, H, hd)))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_flash_forward_matches_jax(case):
    causal, window, off, kc = case[:4]
    q, k, v, _ = _inputs(case)
    want = j_flash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal, window, off, kc)
    got = t_flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal, window, off, kc)
    assert got.shape == q.shape
    _close(got, want)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_flash_vjp_matches_jax(case):
    """The recomputing backward: the gradient of a weighted sum of the
    output with respect to q, k and v."""
    causal, window, off, kc = case[:4]
    q, k, v, w = _inputs(case)

    def j_f(q, k, v):
        return jnp.sum(j_flash.flash_attention(q, k, v, causal, window, off,
                                               kc) * w)

    def t_f(q, k, v):
        return torch.sum(t_flash.flash_attention(q, k, v, causal, window, off,
                                                 kc) * torch.from_numpy(w))

    want = jax.grad(j_f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = torch.func.grad(t_f, argnums=(0, 1, 2))(
        *map(torch.from_numpy, (q, k, v)))
    for name, a, b in zip("qkv", got, want):
        assert a.shape == b.shape
        _close(a, b, f"d{name}")
    # the autograd engine's backward is the same function
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    t_f(qt, kt, vt).backward()
    for name, t, g in zip("qkv", (qt, kt, vt), got):
        assert torch.equal(t.grad, g), name


@pytest.mark.parametrize("case", CASES[:2] + CASES[4:5], ids=_ids)
def test_flash_matches_chunked_attention(case):
    """The same attention as ``layers.chunked_attention`` (one query block,
    no running max in the gradient)."""
    causal, window, off, kc = case[:4]
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(case))
    want = t_layers.chunked_attention(q, k, v, causal=causal, window=window,
                                      q_offset=off, kv_chunk=kc)
    _close(t_flash.flash_attention(q, k, v, causal, window, off, kc), want)


def test_flash_under_vmap_of_grad_is_per_sample():
    """The generated vmap rule: ``vmap(grad)`` over a leading axis equals
    one ``grad`` a sample, bit for bit on the CPU."""
    case = CASES[1]
    causal, window, off, kc = case[:4]
    q, k, v, w = (torch.from_numpy(a) for a in _inputs(case))
    qs = torch.stack([q, 2 * q, -q])

    def loss(qq, kk):
        return torch.sum(t_flash.flash_attention(qq, kk, v, causal, window,
                                                 off, kc) * w)

    g = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)),
                        in_dims=(0, None))(qs, k)
    for i in range(3):
        one = torch.func.grad(loss, argnums=(0, 1))(qs[i], k)
        _close(g[0][i], one[0], "dq")
        _close(g[1][i], one[1], "dk")


def test_flash_saves_only_its_inputs_and_output():
    """What autograd keeps for the backward: q, k, v, out and the (B, KV,
    G, Sq) log-sum-exp, no score block."""
    q, k, v, _ = (torch.from_numpy(a).requires_grad_() for a in
                  _inputs(CASES[0]))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = t_flash.flash_attention(q, k, v, True, 0, 0, 1024)
    assert sorted(saved) == sorted([q.shape, k.shape, v.shape, out.shape,
                                    (2, 2, 2, 16)])


@pytest.mark.parametrize("axis", ["shard_axis", "batch_axis"])
def test_flash_mesh_arguments_raise(axis):
    """The mesh arguments, which raised before Mode B was ported (the name
    is kept), are placements with no effect on the values: the output and
    the vjp with ``axis`` set are bitwise those without it."""
    q, k, v, do = (torch.from_numpy(a).requires_grad_() for a in
                   _inputs(CASES[0]))
    outs = []
    for kw in ({}, {axis: "model"}):
        out = t_flash.flash_attention(q, k, v, **kw)
        outs.append((out,) + torch.autograd.grad(out, (q, k, v), do))
    for got, want in zip(*outs):
        assert torch.equal(got, want)


@pytest.mark.parametrize("impl", ["flash", "chunked"])
def test_attn_impl_dispatch_matches_jax(impl, monkeypatch):
    """``cfg.attn_impl`` picks the attention as the JAX package does:
    "flash" (the default) runs ``flash_attention`` with kv_chunk 1024 and
    no other attention, "chunked" runs ``chunked_attention``; each forward
    matches the JAX package's with the same setting."""
    jcfg = dataclasses.replace(j_configs.get_reduced_config(
        "qwen3-0.6b", d_model=64), attn_impl=impl)
    tcfg = dataclasses.replace(t_configs.get_reduced_config(
        "qwen3-0.6b", d_model=64), attn_impl=impl)
    calls = []
    for mod, name in ((t_tf, "flash_attention"), (t_tf, "chunked_attention")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, a[6] if _name == "flash_attention" else None))
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    jp = j_tf.init_params(jcfg, jax.random.PRNGKey(0))
    tp = zoo_params_from_numpy(jax.tree.map(np.array, jp), device="cpu")
    toks = np.random.default_rng(0).integers(0, 512, (2, 12)).astype(np.int32)
    want, _ = j_tf.forward(jp, jnp.asarray(toks), jcfg)
    got, _ = t_tf.forward(tp, torch.from_numpy(toks), tcfg)
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6 * scale)
    expect = ("flash_attention", 1024) if impl == "flash" else \
        ("chunked_attention", None)
    assert calls == [expect] * tcfg.n_layers
