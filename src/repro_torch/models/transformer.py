"""The decoder stack of the dense family (attention plus a dense MLP), the
port of the JAX package's ``models/transformer.py`` in train mode.

Parameters are a flat ``dict[str, Tensor]`` whose keys join the JAX
package's tree paths with "/" (``embed``, ``final_norm/scale``,
``blocks/b0/mix/wq``, ``blocks/b0/mlp/dense/w1``, ...): the layers of a
group are stacked on a leading (n_groups, ...) axis, as the JAX package's
``vmap`` over the groups leaves them, and the forward pass loops over the
groups. SmolLM-360M's tree is then 11 leaves at any depth, one launch of
the tree reduce. ``convert.zoo_params_from_numpy`` carries a JAX tree over.

Tokens enter through a one-hot product with the embedding, not a gather:
its backward is a matrix product, where a gather's is a scatter-add that a
card may sum in a varying order, and the compiled driver's contract is
bitwise reruns.

Ported: ``init_params``, ``forward`` (train mode) and ``loss_fn`` for the
dense family (smollm-360m, qwen3-0.6b, qwen2.5-32b, codeqwen1.5-7b,
dynabro-mlp), with ``qk_norm``, ``qkv_bias``, tied or untied embeddings,
RMSNorm or LayerNorm, swiglu or gelu and a sliding window. The MoE, hybrid
(Mamba), SSM (RWKV), audio and VLM families and the serving entry points
(``prefill``, ``decode_step``, ``init_cache``) raise ``NotImplementedError``
naming ROADMAP.md queue 1's item that brings them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import (
    apply_norm, apply_rope, chunked_attention, mlp, rms_norm, rope_angles,
)

F32 = torch.float32
Params = Dict[str, torch.Tensor]
ITEM = "The model zoo"  # ROADMAP.md queue 1's item for the rest


def _unported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue 1, "
        f"{ITEM!r})")


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.is_moe:
        _unported(f"the {cfg.family!r} family ({cfg.arch_id})")


# ================================================================ init

# a leaf's initial value: ("normal", scale), "ones" or "zeros"
Init = Union[Tuple[str, float], str]


def _norm_leaves(cfg, pre: str, d: int) -> dict:
    out = {pre + "scale": ((d,), "ones", F32)}
    if cfg.norm == "layernorm":
        out[pre + "bias"] = ((d,), "zeros", F32)
    return out


def _dense(shape, scale=None) -> Init:
    return ("normal", scale if scale is not None else 1.0 / math.sqrt(shape[0]))


def _leaf_specs(cfg: ModelConfig, dtype) -> Dict[str, tuple]:
    """name -> (shape, init, dtype) of every leaf, the JAX package's
    ``init_params`` tree flattened; a block leaf's shape leads with
    n_groups and its scale is the one of a group's leaf."""
    _check_dense(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    H, KV, hd, Fd = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    specs = {"embed": ((V, D), _dense((V, D), 0.02), dtype)}
    specs.update(_norm_leaves(cfg, "final_norm/", D))
    if not cfg.tie_embeddings:
        specs["unembed"] = ((D, V), _dense((D, V)), dtype)
    for i, (mixer, mk) in enumerate(cfg.pattern()):
        if mixer != "attn" or mk != "dense":
            _unported(f"the ({mixer!r}, {mk!r}) block")
        mix, ff = f"blocks/b{i}/mix/", f"blocks/b{i}/mlp/"
        block = dict(_norm_leaves(cfg, mix + "ln/", D))
        for name, shape in (("wq", (D, H * hd)), ("wk", (D, KV * hd)),
                            ("wv", (D, KV * hd)), ("wo", (H * hd, D))):
            block[mix + name] = (shape, _dense(shape), dtype)
        if cfg.qkv_bias:
            for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
                block[mix + name] = ((width,), "zeros", dtype)
        if cfg.qk_norm:
            block[mix + "q_norm"] = ((hd,), "ones", F32)
            block[mix + "k_norm"] = ((hd,), "ones", F32)
        block.update(_norm_leaves(cfg, ff + "ln/", D))
        names = (("w1", (D, Fd)), ("w2", (Fd, D)))
        if cfg.act == "swiglu":
            names += (("w3", (D, Fd)),)
        for name, shape in names:
            block[ff + "dense/" + name] = (shape, _dense(shape), dtype)
        for name, (shape, init, dt) in block.items():
            specs[name] = ((cfg.n_groups,) + shape, init, dt)
    return specs


def init_params(cfg: ModelConfig, key: Union[int, torch.Generator] = 0,
                dtype=F32, device="cuda") -> Params:
    """The dense model's parameters on ``device``, in the JAX package's
    shapes, dtypes and initial distributions (normal weights at 1/√fan_in,
    the embedding at 0.02, unit norm scales, zero biases), drawn leaf by
    leaf in sorted name order from ``key`` (a seed, or a CPU generator) on
    the CPU, so a seed gives the same weights on every device. The draws
    are the port's own; ``convert.zoo_params_from_numpy`` carries the JAX
    package's over."""
    dev = resolve_device(device)
    gen = key if isinstance(key, torch.Generator) else \
        torch.Generator().manual_seed(int(key))
    params = {}
    for name, (shape, init, dt) in sorted(_leaf_specs(cfg, dtype).items()):
        if init == "ones":
            leaf = torch.ones(shape, dtype=dt)
        elif init == "zeros":
            leaf = torch.zeros(shape, dtype=dt)
        else:
            leaf = (torch.randn(shape, generator=gen, dtype=F32)
                    * init[1]).to(dt)
        params[name] = leaf.to(dev)
    return params


# ================================================================ blocks


def _sub(p: Params, pre: str) -> Params:
    """The leaves under ``pre`` (a "…/" prefix), keyed by the rest."""
    return {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}


def _attn_apply(x, p: Params, pre: str, cfg: ModelConfig):
    """Self-attention with its pre-norm and residual; ``p`` one group's
    leaves, ``pre`` the block's "b<i>/mix/"."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = apply_norm(x, _sub(p, pre + "ln/"), cfg.norm)
    q = h @ p[pre + "wq"]
    k = h @ p[pre + "wk"]
    v = h @ p[pre + "wv"]
    if cfg.qkv_bias:
        q, k, v = q + p[pre + "bq"], k + p[pre + "bk"], v + p[pre + "bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p[pre + "q_norm"])
        k = rms_norm(k, p[pre + "k_norm"])
    cos, sin = rope_angles(torch.arange(S, device=x.device), hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = chunked_attention(q, k, v, causal=True, window=cfg.sliding_window)
    return x + out.reshape(B, S, H * hd) @ p[pre + "wo"]


def _mlp_apply(x, p: Params, pre: str, cfg: ModelConfig):
    """The dense MLP with its pre-norm and residual; ``pre`` "b<i>/mlp/"."""
    h = apply_norm(x, _sub(p, pre + "ln/"), cfg.norm)
    return x + mlp(h, _sub(p, pre + "dense/"), cfg.act)


# ================================================================ stack


def _embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """(..., S) tokens -> (..., S, D) rows of the embedding, as a one-hot
    product (see the module docstring)."""
    embed = params["embed"]
    vocab = torch.arange(embed.shape[0], device=embed.device)
    onehot = (tokens.to(torch.int64)[..., None] == vocab).to(embed.dtype)
    return onehot @ embed


def _unembed(params: Params, x, cfg: ModelConfig):
    x = apply_norm(x, _sub(params, "final_norm/"), cfg.norm)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x @ w


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            extra: Optional[dict] = None, mode: str = "train"):
    """Full causal forward of (B, S) tokens. Returns (logits (B, S, V),
    aux), aux the router loss (0: the dense family has no router)."""
    _check_dense(cfg)
    if mode != "train":
        _unported(f"forward(mode={mode!r}) (prefill and decode, for serving)")
    if extra is not None:
        _unported("the audio/vlm families' extra inputs")
    x = _embed_tokens(params, tokens)
    groups = {k[len("blocks/"):]: v.unbind(0) for k, v in params.items()
              if k.startswith("blocks/")}
    for g in range(cfg.n_groups):
        gp = {k: v[g] for k, v in groups.items()}
        for i in range(len(cfg.pattern())):
            x = _attn_apply(x, gp, f"b{i}/mix/", cfg)
            x = _mlp_apply(x, gp, f"b{i}/mlp/", cfg)
    logits = _unembed(params, x, cfg)
    return logits, torch.zeros((), dtype=F32, device=logits.device)


def loss_fn(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy + router aux."""
    logits, aux = forward(params, batch["tokens"], cfg, extra=batch.get("extra"))
    labels = batch["labels"].to(torch.int64)
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (lse - gold).mean()
    return nll + cfg.router_aux_weight * aux


# ---------------------------------------------------------------- serving


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None):
    """The decode cache: not ported (serving)."""
    _unported("init_cache (serving)")


def decode_step(params: Params, cache, token, pos, cfg: ModelConfig):
    """One serving step: not ported (serving)."""
    _unported("decode_step (serving)")


def prefill(params: Params, tokens, cfg: ModelConfig, extra=None,
            pad_to: int = 0):
    """Prefill pass: not ported (serving)."""
    _unported("prefill (serving)")
