"""The decoder stack of every family of the model zoo (dense, MoE, hybrid
Mamba, RWKV, audio encoder-decoder, VLM cross-attention), the port of the
JAX package's ``models/transformer.py`` in train mode.

Parameters are a flat ``dict[str, Tensor]`` whose keys join the JAX
package's tree paths with "/" (``embed``, ``final_norm/scale``,
``blocks/b0/mix/wq``, ``blocks/b0/mlp/moe/we1``,
``encoder/blocks/attn/wq``, ...): the layers of a group are stacked on a
leading (n_groups, ...) axis and the encoder's layers on a leading
(n_encoder_layers, ...) axis, as the JAX package's ``vmap``s leave them,
and the forward pass loops over them. SmolLM-360M's tree is then 11 leaves
at any depth, one launch of the tree reduce. ``convert.zoo_params_from_
numpy`` carries a JAX tree over.

Tokens enter through a one-hot product with the embedding, not a gather:
its backward is a matrix product, where a gather's is a scatter-add that a
card may sum in a varying order, and the compiled driver's contract is
bitwise reruns. Attention is ``flash.flash_attention`` for the default
``attn_impl="flash"`` (kv_chunk 1024) and ``layers.chunked_attention`` for
``"chunked"``, as in the JAX package.

Ported: ``init_params``, ``forward`` (train mode) and ``loss_fn`` (with the
router's load-balance aux) for every architecture of the registry. The
decode entry points (``prefill``, ``decode_step``, ``init_cache``,
``forward(mode=...)`` other than "train") and ``forward(remat=)`` raise
``NotImplementedError`` naming ROADMAP.md queue 1's item that brings them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import ssm
from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import (
    apply_norm, apply_rope, chunked_attention, mlp, rms_norm, rope_angles,
)
from repro_torch.models.moe import moe_ffn

F32 = torch.float32
Params = Dict[str, torch.Tensor]
ITEM = "The model zoo"  # ROADMAP.md queue 1's item for the rest
DEC_POS = 32768  # rows of the audio decoder's learned position table


def _unported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue 1, "
        f"{ITEM!r})")


# ================================================================ init

# a leaf's initial value: ("normal", scale), ("full", value), "ones",
# "zeros" or "alog" (log(1..d_state), broadcast over the channels)
Init = Union[Tuple[str, float], str]
Spec = Tuple[tuple, Init, torch.dtype]  # shape, init, dtype


def _norm_leaves(cfg, d: int) -> Dict[str, Spec]:
    out = {"scale": ((d,), "ones", F32)}
    if cfg.norm == "layernorm":
        out["bias"] = ((d,), "zeros", F32)
    return out


def _dense(shape, dtype, scale=None) -> Spec:
    return (shape, ("normal", scale if scale is not None
                    else 1.0 / math.sqrt(shape[0])), dtype)


def _under(pre: str, leaves: Dict[str, Spec]) -> Dict[str, Spec]:
    return {pre + k: v for k, v in leaves.items()}


def _attn_leaves(cfg, dtype) -> Dict[str, Spec]:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = _under("ln/", _norm_leaves(cfg, D))
    for name, shape in (("wq", (D, H * hd)), ("wk", (D, KV * hd)),
                        ("wv", (D, KV * hd)), ("wo", (H * hd, D))):
        p[name] = _dense(shape, dtype)
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = ((width,), "zeros", dtype)
    if cfg.qk_norm:
        p["q_norm"] = ((hd,), "ones", F32)
        p["k_norm"] = ((hd,), "ones", F32)
    return p


def _mlp_leaves(cfg, dtype, d_ff=None) -> Dict[str, Spec]:
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    p = {"w1": _dense((D, Fd), dtype), "w2": _dense((Fd, D), dtype)}
    if cfg.act == "swiglu":
        p["w3"] = _dense((D, Fd), dtype)
    return p


def _moe_leaves(cfg, dtype) -> Dict[str, Spec]:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": _dense((D, E), F32),
         "we1": _dense((E, D, Fd), dtype, 1.0 / math.sqrt(D)),
         "we2": _dense((E, Fd, D), dtype, 1.0 / math.sqrt(Fd))}
    if cfg.act == "swiglu":
        p["we3"] = _dense((E, D, Fd), dtype, 1.0 / math.sqrt(D))
    if cfg.n_shared_experts:
        p.update(_under("shared/", _mlp_leaves(cfg, dtype, cfg.shared_d_ff)))
    return p


def _mamba_leaves(cfg, dtype) -> Dict[str, Spec]:
    D = cfg.d_model
    di, ds, k = cfg.mamba_expand * D, cfg.mamba_d_state, cfg.mamba_conv
    dt_rank = max(1, D // 16)
    p = _under("ln/", _norm_leaves(cfg, D))
    p.update({
        "in_proj": _dense((D, 2 * di), dtype),
        "conv_w": _dense((k, di), dtype, 1.0 / math.sqrt(k)),
        "conv_b": ((di,), "zeros", dtype),
        "x_proj": _dense((di, dt_rank + 2 * ds), dtype),
        "dt_proj": _dense((dt_rank, di), dtype),
        "dt_bias": ((di,), ("full", math.log(math.e ** 0.01 - 1)), F32),
        "A_log": ((di, ds), "alog", F32),
        "D": ((di,), "ones", F32),
        "out_proj": _dense((di, D), dtype),
    })
    return p


def _rwkv_leaves(cfg, dtype) -> Dict[str, Spec]:
    D, lr = cfg.d_model, 64
    p = _under("ln/", _norm_leaves(cfg, D))
    for n in ("wr", "wk", "wv", "wg", "wo"):
        p[n] = _dense((D, D), dtype)
    for n in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
        p[n] = ((D,), ("full", 0.5), dtype)
    p["w0"] = ((D,), ("full", -2.0), F32)
    p["w1"] = _dense((D, lr), F32)
    p["w2"] = _dense((lr, D), F32, 0.01)
    p["u"] = ((D,), "zeros", F32)
    p["ln_x"] = ((D,), "ones", F32)
    return p


def _cmix_leaves(cfg, dtype) -> Dict[str, Spec]:
    D, Fd = cfg.d_model, cfg.d_ff
    p = _under("ln/", _norm_leaves(cfg, D))
    p.update({"mu_k": ((D,), ("full", 0.5), dtype),
              "mu_r": ((D,), ("full", 0.5), dtype),
              "wk": _dense((D, Fd), dtype), "wv": _dense((Fd, D), dtype),
              "wr": _dense((D, D), dtype)})
    return p


def _block_leaves(cfg, mixer: str, mlp_kind: str, dtype) -> Dict[str, Spec]:
    """One layer's leaves, keyed under "mix/", "cross/" and "mlp/"."""
    p: Dict[str, Spec] = {}
    if mixer in ("attn", "cross_attn"):
        p.update(_under("mix/", _attn_leaves(cfg, dtype)))
        if cfg.family == "audio":  # whisper decoder: self + cross per layer
            p.update(_under("cross/", _attn_leaves(cfg, dtype)))
    elif mixer == "mamba":
        p.update(_under("mix/", _mamba_leaves(cfg, dtype)))
    elif mixer == "rwkv":
        p.update(_under("mix/", _rwkv_leaves(cfg, dtype)))
    if mlp_kind == "rwkv_cmix":
        p.update(_under("mlp/", _cmix_leaves(cfg, dtype)))
        return p
    p.update(_under("mlp/ln/", _norm_leaves(cfg, cfg.d_model)))
    if mlp_kind in ("moe", "moe+dense"):
        p.update(_under("mlp/moe/", _moe_leaves(cfg, dtype)))
    if mlp_kind != "moe":
        p.update(_under("mlp/dense/", _mlp_leaves(cfg, dtype)))
    return p


def _stacked(n: int, pre: str, leaves: Dict[str, Spec]) -> Dict[str, Spec]:
    return {pre + k: ((n,) + shape, init, dt)
            for k, (shape, init, dt) in leaves.items()}


def _leaf_specs(cfg: ModelConfig, dtype) -> Dict[str, Spec]:
    """name -> (shape, init, dtype) of every leaf, the JAX package's
    ``init_params`` tree flattened; a stacked leaf's shape leads with
    n_groups (n_encoder_layers for the encoder's) and its scale is the one
    of a layer's leaf."""
    D, V = cfg.d_model, cfg.vocab_size
    specs = {"embed": _dense((V, D), dtype, 0.02)}
    specs.update(_under("final_norm/", _norm_leaves(cfg, D)))
    if not cfg.tie_embeddings:
        specs["unembed"] = _dense((D, V), dtype)
    for i, (mixer, mk) in enumerate(cfg.pattern()):
        specs.update(_stacked(cfg.n_groups, f"blocks/b{i}/",
                              _block_leaves(cfg, mixer, mk, dtype)))
    if cfg.family == "audio":
        enc = _under("attn/", _attn_leaves(cfg, dtype))
        enc.update(_under("mlp/ln/", _norm_leaves(cfg, D)))
        enc.update(_under("mlp/dense/", _mlp_leaves(cfg, dtype)))
        specs.update(_stacked(cfg.n_encoder_layers, "encoder/blocks/", enc))
        specs.update(_under("encoder/final_norm/", _norm_leaves(cfg, D)))
        specs["dec_pos"] = _dense((DEC_POS, D), dtype, 0.02)
    return specs


def _initial(shape, init: Init, dt, gen: torch.Generator) -> torch.Tensor:
    if init == "ones":
        return torch.ones(shape, dtype=dt)
    if init == "zeros":
        return torch.zeros(shape, dtype=dt)
    if init == "alog":  # shape (..., di, ds)
        ar = torch.arange(1, shape[-1] + 1, dtype=F32)
        return torch.log(ar).expand(shape).to(dt).clone()
    kind, value = init
    if kind == "full":
        return torch.full(shape, value, dtype=dt)
    return (torch.randn(shape, generator=gen, dtype=F32) * value).to(dt)


def init_params(cfg: ModelConfig, key: Union[int, torch.Generator] = 0,
                dtype=F32, device="cuda") -> Params:
    """The model's parameters on ``device``, in the JAX package's shapes,
    dtypes and initial values (normal weights at 1/√fan_in, the embeddings
    at 0.02, unit norm scales, zero biases, the Mamba and RWKV constants),
    the normal leaves drawn one by one in sorted name order from ``key`` (a
    seed, or a CPU generator) on the CPU, so a seed gives the same weights
    on every device. The draws are the port's own;
    ``convert.zoo_params_from_numpy`` carries the JAX package's over."""
    dev = resolve_device(device)
    gen = key if isinstance(key, torch.Generator) else \
        torch.Generator().manual_seed(int(key))
    return {name: _initial(shape, init, dt, gen).to(dev)
            for name, (shape, init, dt) in sorted(_leaf_specs(cfg, dtype).items())}


# ================================================================ blocks


def _sub(p: Params, pre: str) -> Params:
    """The leaves under ``pre`` (a "…/" prefix), keyed by the rest."""
    return {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}


def _layers(params: Params, pre: str, n: int):
    """The n layers stacked under ``pre``: one dict of a layer's leaves
    each, keyed by the rest of the name."""
    stacked = {k: v.unbind(0) for k, v in _sub(params, pre).items()}
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def _attn_apply(x, p: Params, cfg: ModelConfig, *, cross=False, kv_src=None,
                causal=True):
    """Attention with its pre-norm and residual; ``p`` the block's attention
    leaves. ``cross`` attends from x to ``kv_src`` (B, E, D): no RoPE, no
    mask, no window. The audio family takes no RoPE at all."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = apply_norm(x, _sub(p, "ln/"), cfg.norm)
    src = kv_src if cross else h
    q = h @ p["wq"]
    k = src @ p["wk"]
    v = src @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, -1, KV, hd)
    v = v.reshape(B, -1, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.family != "audio" and not cross:
        cos, sin = rope_angles(torch.arange(S, device=x.device), hd,
                               cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    window = 0 if cross else cfg.sliding_window
    if cfg.attn_impl == "flash":
        out = flash_attention(q, k, v, causal and not cross, window, 0, 1024,
                              cfg.attn_seq_shard, cfg.attn_batch_shard)
    else:
        out = chunked_attention(q, k, v, causal=causal and not cross,
                                window=window)
    return x + out.reshape(B, S, H * hd) @ p["wo"]


def _mlp_apply(x, p: Params, cfg: ModelConfig, mlp_kind: str):
    """The layer's MLP with its pre-norm and residual. Returns (x, aux),
    aux the router's load-balance loss (None without a router)."""
    h = apply_norm(x, _sub(p, "ln/"), cfg.norm)
    if mlp_kind == "rwkv_cmix":
        return x + ssm.rwkv_channel_mix(h, p)[0], None
    moe = _sub(p, "moe/")
    if not moe:
        return x + mlp(h, _sub(p, "dense/"), cfg.act), None
    out, aux = moe_ffn(h, moe, top_k=cfg.top_k,
                       capacity_factor=cfg.capacity_factor, act=cfg.act,
                       token_group=cfg.moe_token_group,
                       expert_shard=cfg.moe_expert_shard)
    shared = _sub(moe, "shared/")
    if shared:
        out = out + mlp(h, shared, cfg.act)
    if mlp_kind == "moe+dense":
        out = out + mlp(h, _sub(p, "dense/"), cfg.act)
    return x + out, aux


def _block_apply(x, p: Params, cfg: ModelConfig, mixer: str, mlp_kind: str,
                 kv_src=None):
    """One layer; ``p`` its leaves keyed "mix/…", "cross/…", "mlp/…".
    Returns (x, aux or None)."""
    mix = _sub(p, "mix/")
    if mixer in ("attn", "cross_attn"):
        x = _attn_apply(x, mix, cfg, cross=mixer == "cross_attn", kv_src=kv_src)
        if cfg.family == "audio":  # whisper decoder adds cross-attn
            x = _attn_apply(x, _sub(p, "cross/"), cfg, cross=True,
                            kv_src=kv_src)
    elif mixer == "mamba":
        h = apply_norm(x, _sub(mix, "ln/"), cfg.norm)
        x = x + ssm.mamba_mixer(h, mix, cfg)[0]
    elif mixer == "rwkv":
        h = apply_norm(x, _sub(mix, "ln/"), cfg.norm)
        x = x + ssm.rwkv_time_mix(h, mix, cfg)[0]
    return _mlp_apply(x, _sub(p, "mlp/"), cfg, mlp_kind)


# ================================================================ stacks


def _sinusoids(S: int, D: int, device) -> torch.Tensor:
    """(S, D) encoder positions: [sin | cos] of pos / 10000^(2i/D)."""
    pos = torch.arange(S, device=device, dtype=F32)[:, None]
    dim = torch.arange(D // 2, device=device, dtype=F32)[None, :]
    ang = pos / (10000 ** (2 * dim / D))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _encoder_forward(params: Params, frames: torch.Tensor, cfg: ModelConfig):
    """The audio encoder over stubbed frame embeddings (B, Senc, D):
    sinusoidal positions, bidirectional attention and a dense MLP a layer,
    and its final norm."""
    x = frames + _sinusoids(frames.shape[1], cfg.d_model,
                            frames.device).to(frames.dtype)[None]
    for lp in _layers(params, "encoder/blocks/", cfg.n_encoder_layers):
        x = _attn_apply(x, _sub(lp, "attn/"), cfg, causal=False)
        x, _ = _mlp_apply(x, _sub(lp, "mlp/"), cfg, "dense")
    return apply_norm(x, _sub(params, "encoder/final_norm/"), cfg.norm)


def _embed_tokens(params: Params, tokens: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """(..., S) tokens -> (..., S, D) rows of the embedding, as a one-hot
    product (see the module docstring); the audio decoder adds its learned
    positions ``dec_pos[:S]``."""
    embed = params["embed"]
    vocab = torch.arange(embed.shape[0], device=embed.device)
    onehot = (tokens.to(torch.int64)[..., None] == vocab).to(embed.dtype)
    x = onehot @ embed
    if cfg.family == "audio":
        x = x + params["dec_pos"][:tokens.shape[-1]]
    return x


def _unembed(params: Params, x, cfg: ModelConfig):
    x = apply_norm(x, _sub(params, "final_norm/"), cfg.norm)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x @ w


def _kv_src(params: Params, cfg: ModelConfig, extra: dict):
    """What cross-attention reads: the audio encoder's output over
    ``extra["frames"]``, the VLM's ``extra["patches"]``, else None."""
    if cfg.family == "audio":
        return _encoder_forward(params, extra["frames"], cfg)
    if cfg.family == "vlm":
        return extra["patches"]
    return None


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            extra: Optional[dict] = None, mode: str = "train"):
    """Full causal forward of (B, S) tokens, ``extra`` the audio family's
    {"frames": (B, encoder_seq, D)} or the VLM's {"patches": (B,
    n_image_tokens, D)} (ignored by the other families). Returns (logits (B,
    S, V), aux), aux the routers' load-balance loss summed over the layer
    groups (0 without a router)."""
    if mode != "train":
        _unported(f"forward(mode={mode!r}) (the decode entry points)")
    x = _embed_tokens(params, tokens, cfg)
    kv_src = _kv_src(params, cfg, extra or {})
    auxs = []
    for gp in _layers(params, "blocks/", cfg.n_groups):
        aux = torch.zeros((), dtype=F32, device=x.device)
        for i, (mixer, mk) in enumerate(cfg.pattern()):
            x, a = _block_apply(x, _sub(gp, f"b{i}/"), cfg, mixer, mk, kv_src)
            if a is not None:
                aux = aux + a
        auxs.append(aux)
    logits = _unembed(params, x, cfg)
    return logits, torch.stack(auxs).sum()


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
    """The decode cache: not ported (the decode entry points)."""
    _unported("init_cache (the decode entry points)")


def decode_step(params: Params, cache, token, pos, cfg: ModelConfig):
    """One serving step: not ported (the decode entry points)."""
    _unported("decode_step (the decode entry points)")


def prefill(params: Params, tokens, cfg: ModelConfig, extra=None,
            pad_to: int = 0):
    """Prefill pass: not ported (the decode entry points)."""
    _unported("prefill (the decode entry points)")
