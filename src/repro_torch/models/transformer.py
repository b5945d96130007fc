"""The decoder stack of every family of the model zoo (dense, MoE, hybrid
Mamba, RWKV, audio encoder-decoder, VLM cross-attention), the port of the
JAX package's ``models/transformer.py``.

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

Entry points, for every architecture of the registry: ``init_params``,
``forward`` (train and prefill mode) and ``loss_fn`` (with the router's
load-balance aux); and the serving ones, ``init_cache``, ``prefill`` and
``decode_step``. A cache is a flat ``dict[str, Tensor]`` keyed like the
params under "blocks/" (``b0/mix/k``, ``b0/cross/v``, ``b1/mlp/prev``,
...), each leaf stacked on a leading (n_groups, ...) axis;
``convert.zoo_cache_from_numpy`` carries a JAX cache over. ``decode_step``
returns a new cache and leaves its argument as it was; given ``pos`` as a
tensor on the card it reads nothing back to the host. A self-attention
cache is a ring: position p goes to slot p % its length, as in the JAX
package, whose windowed prefill cache (the last ``sliding_window`` keys in
slots 0..W-1) agrees with that ring only when the prompt's length is a
multiple of W; the port keeps that layout (ROADMAP.md §3).

``forward(remat=True)``, the default as in the JAX package, recomputes each
layer group in train mode: a ``torch.autograd.Function`` (``_Group``) keeps
the group's input, what its cross-attention reads and its parameter slices,
and its backward runs the group again under ``torch.func.vjp``. It runs
under ``torch.func.vmap(torch.func.grad(...))`` and in a captured CUDA
graph, and its gradients equal ``remat=False``'s bitwise. The audio encoder
is not recomputed, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import ssm
from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import (
    apply_norm, apply_rope, chunked_attention, decode_attention, mlp,
    recompute_vjp, rms_norm, rope_angles,
)
from repro_torch.models.moe import moe_ffn

F32 = torch.float32
Params = Dict[str, torch.Tensor]
DEC_POS = 32768  # rows of the audio decoder's learned position table


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
                causal=True, cache=None, pos=None, mode="train", pad_to=0):
    """Attention with its pre-norm and residual; ``p`` the block's attention
    leaves. ``cross`` attends from x to ``kv_src`` (B, E, D): no RoPE, no
    mask, no window. The audio family takes no RoPE at all. Returns (x, the
    new cache): None in train mode; in prefill mode k and v, the last
    ``sliding_window`` of them for a windowed self-attention, else padded
    with zeros to ``pad_to`` slots (self-attention only); in decode mode
    (one token at ``pos``) the cache: self-attention writes k and v, cast
    to the cache's dtype, at slot pos % its length and attends to the
    slots below min(pos + 1, length); cross-attention reads its cached k
    and v and computes none."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = apply_norm(x, _sub(p, "ln/"), cfg.norm)
    q = h @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(B, S, H, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    rope = cfg.family != "audio" and not cross
    if cross and mode == "decode":
        out = decode_attention(q, cache["k"], cache["v"])
        return x + out.reshape(B, S, H * hd) @ p["wo"], cache
    # ``_Group`` hands a cross-attention a (k source, v source) pair: one
    # tensor each, so that each use's gradient stays apart
    k_src, v_src = ((kv_src if isinstance(kv_src, tuple) else (kv_src, kv_src))
                    if cross else (h, h))
    k = k_src @ p["wk"]
    v = v_src @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(B, -1, KV, hd)
    v = v.reshape(B, -1, KV, hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    if mode == "decode":
        out, new_cache = _decode_self_attention(q, k, v, cache, pos, cfg, rope)
        return x + out.reshape(B, S, H * hd) @ p["wo"], new_cache
    if rope:
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
    new_cache = None
    if mode == "prefill":
        if window:
            k, v = k[:, -window:], v[:, -window:]
        elif pad_to > k.shape[1] and not cross:
            pad = (0, 0, 0, 0, 0, pad_to - k.shape[1])
            k, v = F.pad(k, pad), F.pad(v, pad)
        new_cache = {"k": k, "v": v}
    return x + out.reshape(B, S, H * hd) @ p["wo"], new_cache


def _decode_self_attention(q, k, v, cache, pos, cfg: ModelConfig, rope: bool):
    """One token's self-attention against the ring ``cache`` {k, v} (B, Sc,
    KV, hd) at position ``pos`` (a 0-d tensor): RoPE at pos, k and v cast
    to the cache's dtype into slot pos % Sc, a mask of the slots below
    min(pos + 1, Sc). Returns (out (B, 1, H, hd), the new cache); no value
    is read back to the host."""
    B, Sc = q.shape[0], cache["k"].shape[1]
    if rope:
        cos, sin = rope_angles(pos[None], cfg.hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    slots = torch.arange(Sc, device=q.device)
    at = (slots == pos % Sc)[None, :, None, None]
    kc = torch.where(at, k.to(cache["k"].dtype), cache["k"])
    vc = torch.where(at, v.to(cache["v"].dtype), cache["v"])
    valid = slots < torch.clamp(pos + 1, max=Sc)
    out = decode_attention(q, kc, vc, valid[None].expand(B, Sc))
    return out, {"k": kc, "v": vc}


def _mlp_apply(x, p: Params, cfg: ModelConfig, mlp_kind: str, *, cache=None,
               mode="train"):
    """The layer's MLP with its pre-norm and residual. Returns (x, aux, the
    new cache), aux the router's load-balance loss (None without a router);
    only RWKV's channel mix has a cache (None in train mode)."""
    h = apply_norm(x, _sub(p, "ln/"), cfg.norm)
    if mlp_kind == "rwkv_cmix":
        out, c = ssm.rwkv_channel_mix(h, p, cache if mode == "decode" else None)
        return x + out, None, None if mode == "train" else c
    moe = _sub(p, "moe/")
    if not moe:
        return x + mlp(h, _sub(p, "dense/"), cfg.act), None, None
    out, aux = moe_ffn(h, moe, top_k=cfg.top_k,
                       capacity_factor=cfg.capacity_factor, act=cfg.act,
                       token_group=cfg.moe_token_group,
                       expert_shard=cfg.moe_expert_shard)
    shared = _sub(moe, "shared/")
    if shared:
        out = out + mlp(h, shared, cfg.act)
    if mlp_kind == "moe+dense":
        out = out + mlp(h, _sub(p, "dense/"), cfg.act)
    return x + out, aux, None


def _block_apply(x, p: Params, cfg: ModelConfig, mixer: str, mlp_kind: str,
                 kv_src=None, *, cache=None, pos=None, mode="train", pad_to=0):
    """One layer; ``p`` its leaves keyed "mix/…", "cross/…", "mlp/…", and
    ``cache`` (decode) its cache leaves keyed alike. Returns (x, aux or
    None, the layer's new cache leaves: empty in train mode)."""
    cache = cache or {}
    new_cache = {}
    mix = _sub(p, "mix/")
    if mixer in ("attn", "cross_attn"):
        x, c = _attn_apply(x, mix, cfg, cross=mixer == "cross_attn",
                           kv_src=kv_src, cache=_sub(cache, "mix/"), pos=pos,
                           mode=mode, pad_to=pad_to)
        new_cache.update(_under("mix/", c or {}))
        if cfg.family == "audio":  # whisper decoder adds cross-attn
            x, c = _attn_apply(x, _sub(p, "cross/"), cfg, cross=True,
                               kv_src=kv_src, cache=_sub(cache, "cross/"),
                               pos=pos, mode=mode)
            new_cache.update(_under("cross/", c or {}))
    elif mixer in ("mamba", "rwkv"):
        h = apply_norm(x, _sub(mix, "ln/"), cfg.norm)
        mixer_fn = ssm.mamba_mixer if mixer == "mamba" else ssm.rwkv_time_mix
        out, c = mixer_fn(h, mix, cfg,
                          cache=_sub(cache, "mix/") if mode == "decode" else None)
        x = x + out
        if mode != "train":
            new_cache.update(_under("mix/", c))
    x, aux, c = _mlp_apply(x, _sub(p, "mlp/"), cfg, mlp_kind,
                           cache=_sub(cache, "mlp/"), mode=mode)
    new_cache.update(_under("mlp/", c or {}))
    return x, aux, new_cache


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
        x, _ = _attn_apply(x, _sub(lp, "attn/"), cfg, causal=False)
        x, _, _ = _mlp_apply(x, _sub(lp, "mlp/"), cfg, "dense")
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


def _reads_kv(cfg: ModelConfig, mixer: str) -> bool:
    """Whether a layer's cross-attention reads ``kv_src``: the VLM's
    cross-attention layers and every layer of the audio decoder."""
    return mixer == "cross_attn" or (mixer == "attn" and cfg.family == "audio")


def _group(x, gp: Params, cfg: ModelConfig, kv_src, *, mode="train",
           pad_to=0):
    """One layer group: its layers in pattern order, ``gp`` the group's
    leaves keyed "b{i}/…". ``kv_src`` is what cross-attention reads (None,
    or a tensor), or a list of one (k source, v source) pair a layer that
    reads it (``_Group``). Returns (x, the group's router aux, its cache
    leaves)."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    cache = {}
    pairs = iter(kv_src) if isinstance(kv_src, list) else None
    for i, (mixer, mk) in enumerate(cfg.pattern()):
        kv = next(pairs) if pairs is not None and _reads_kv(cfg, mixer) \
            else kv_src
        x, a, c = _block_apply(x, _sub(gp, f"b{i}/"), cfg, mixer, mk, kv,
                               mode=mode, pad_to=pad_to)
        if a is not None:
            aux = aux + a
        cache.update(_under(f"b{i}/", c))
    return x, aux, cache


def _group_fn(cfg: ModelConfig, names: Tuple[str, ...], n_kv: int, hook, x,
              *rest):
    """``_group`` in train mode over positional tensors: x, ``n_kv`` copies
    of ``kv_src`` in reverse order of use (a reading layer's k source, then
    its v source), then the group's leaves in the order of ``names``, passed
    through ``hook(leaves, "blocks")`` where one is given. Returns (x,
    aux)."""
    uses = rest[:n_kv][::-1]
    pairs = [(uses[i], uses[i + 1]) for i in range(0, n_kv, 2)]
    gp = dict(zip(names, rest[n_kv:]))
    if hook is not None:
        gp = hook(gp, "blocks")
    x, aux, _ = _group(x, gp, cfg, pairs or None)
    return x, aux


class _Group(torch.autograd.Function):
    """A layer group recomputed in the backward, the port of the JAX
    package's ``jax.checkpoint(group_body)``: it keeps only its inputs (x,
    the kv_src copies and the group's parameter slices, views of the
    stacked leaves) and its backward runs ``_group_fn`` again under
    ``torch.func.vjp``. The same ops run on the same values, and the
    autograd engine sums a tensor's gradients latest use first, and a
    Function's input gradients in input order: with one kv_src copy a use,
    in reverse order of use, kv_src's gradient is summed over the groups in
    the order of the un-recomputed graph, bitwise. Under a param hook
    (Mode B) the slices are the rank's blocks and the hook runs inside
    ``_group_fn``: the backward gathers them again, so one group's full
    parameters are alive at a time, as under the JAX package's checkpoint."""

    generate_vmap_rule = True

    @staticmethod
    def forward(cfg, names, n_kv, hook, x, *rest):
        return _group_fn(cfg, names, n_kv, hook, x, *rest)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[:4]
        ctx.save_for_backward(*inputs[4:])

    @staticmethod
    def backward(ctx, dx, daux):
        return (None, None, None, None) + recompute_vjp(
            lambda *a: _group_fn(*ctx.args, *a), ctx.saved_tensors, (dx, daux))


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            extra: Optional[dict] = None, mode: str = "train",
            remat: bool = True, pad_to: int = 0, param_hook=None):
    """Full causal forward of (B, S) tokens, ``extra`` the audio family's
    {"frames": (B, encoder_seq, D)} or the VLM's {"patches": (B,
    n_image_tokens, D)} (ignored by the other families). Returns (logits (B,
    S, V), aux) in train mode and (logits, aux, cache) in prefill mode
    (``mode="prefill"``; ``pad_to`` as in ``prefill``), aux the routers'
    load-balance loss summed over the layer groups (0 without a router).

    ``remat=True`` (the default, as in the JAX package) recomputes each
    layer group in the backward (``_Group``) in train mode, with the same
    values and gradients, bitwise, as ``remat=False``; outside train mode
    ``remat`` changes nothing, as in the JAX package.

    ``param_hook(leaves, scope)`` transforms parameters at their point of
    use: once on scope "top" (every leaf outside "blocks/"), and on scope
    "blocks" for each layer group's slices (keyed under "blocks/"), inside
    the group's recompute. Mode B threads its robust-aggregating gather
    through it (``core/sharded.ParamHook``)."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward: mode {mode!r} is not 'train' or "
                         "'prefill' (decode_step runs one decode step)")
    if param_hook is not None:
        top = param_hook({k: v for k, v in params.items()
                          if not k.startswith("blocks/")}, "top")
        params = {**top, **{k: v for k, v in params.items()
                            if k.startswith("blocks/")}}
    x = _embed_tokens(params, tokens, cfg)
    kv_src = _kv_src(params, cfg, extra or {})
    recompute = remat and mode == "train"
    if recompute:
        n_kv = 2 * sum(_reads_kv(cfg, mixer) for mixer, _ in cfg.pattern())
        kv = (kv_src,) * n_kv if kv_src is not None else ()
    auxs, caches = [], []
    for gp in _layers(params, "blocks/", cfg.n_groups):
        if recompute:
            names = tuple(sorted(gp))
            x, aux = _Group.apply(cfg, names, len(kv), param_hook, x, *kv,
                                  *(gp[k] for k in names))
            cache = {}
        else:
            if param_hook is not None:
                gp = param_hook(gp, "blocks")
            x, aux, cache = _group(x, gp, cfg, kv_src, mode=mode,
                                   pad_to=pad_to)
        auxs.append(aux)
        caches.append(cache)
    logits = _unembed(params, x, cfg)
    aux = torch.stack(auxs).sum()
    if mode == "prefill":
        return logits, aux, _stack_groups(caches)
    return logits, aux


def loss_fn(params: Params, batch: dict, cfg: ModelConfig,
            param_hook=None) -> torch.Tensor:
    """Mean next-token cross-entropy + router aux; ``param_hook`` as in
    ``forward``."""
    logits, aux = forward(params, batch["tokens"], cfg, extra=batch.get("extra"),
                          param_hook=param_hook)
    labels = batch["labels"].to(torch.int64)
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (lse - gold).mean()
    return nll + cfg.router_aux_weight * aux


# ---------------------------------------------------------------- serving


def _stack_groups(caches):
    """One cache dict a layer group -> each leaf stacked over the groups."""
    return {k: torch.stack([c[k] for c in caches]) for k in sorted(caches[0])}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda") -> Params:
    """An empty decode cache on ``device``, the JAX package's ``init_cache``
    flattened: per layer of a group, self-attention k/v (batch, seq_len or
    the sliding window if smaller, KV, hd), whisper's cross k/v (batch,
    encoder_seq, KV, hd), the VLM's (batch, n_image_tokens, KV, hd),
    Mamba's conv (batch, mamba_conv - 1, d_inner) and ssm (batch, d_inner,
    d_state), RWKV's prev (batch, D) and state (batch, H, hd, hd), the
    channel mix's prev (batch, D); every leaf zeros in ``dtype`` but the
    ssm and wkv states, float32, and stacked over n_groups."""
    dev = resolve_device(device)
    KV, hd, D = cfg.n_kv_heads, cfg.hd, cfg.d_model
    S_eff = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    leaves = {}
    for i, (mixer, mk) in enumerate(cfg.pattern()):
        b = f"b{i}/"
        if mixer == "attn":
            for n in ("k", "v"):
                leaves[f"{b}mix/{n}"] = ((batch, S_eff, KV, hd), dtype)
                if cfg.family == "audio":
                    leaves[f"{b}cross/{n}"] = (
                        (batch, cfg.encoder_seq, KV, hd), dtype)
        elif mixer == "cross_attn":
            for n in ("k", "v"):
                leaves[f"{b}mix/{n}"] = (
                    (batch, cfg.n_image_tokens, KV, hd), dtype)
        elif mixer == "mamba":
            di = cfg.mamba_expand * D
            leaves[b + "mix/conv"] = ((batch, cfg.mamba_conv - 1, di), dtype)
            leaves[b + "mix/ssm"] = ((batch, di, cfg.mamba_d_state), F32)
        elif mixer == "rwkv":
            rhd = cfg.rwkv_head_dim
            leaves[b + "mix/prev"] = ((batch, D), dtype)
            leaves[b + "mix/state"] = ((batch, D // rhd, rhd, rhd), F32)
        if mk == "rwkv_cmix":
            leaves[b + "mlp/prev"] = ((batch, D), dtype)
    return {k: torch.zeros((cfg.n_groups,) + shape, dtype=dt, device=dev)
            for k, (shape, dt) in sorted(leaves.items())}


@torch.no_grad()
def decode_step(params: Params, cache: Params, token: torch.Tensor, pos,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One serving step: token (B,) ints at position ``pos`` (the tokens so
    far: an int or a 0-d integer tensor, best on the params' device, where
    the step then reads nothing back to the host). Returns (logits (B, V),
    the new cache); ``cache`` is left as it was. The embedding row is read
    by index (no gradient flows here), the audio decoder's learned position
    row at ``pos``."""
    embed = params["embed"]
    pos = torch.as_tensor(pos, device=embed.device)
    x = embed.index_select(0, token.to(torch.int64))[:, None]  # (B, 1, D)
    if cfg.family == "audio":
        row = torch.clamp(pos, 0, DEC_POS - 1).reshape(1)
        x = x + params["dec_pos"].index_select(0, row)
    caches = []
    for g, gp in enumerate(_layers(params, "blocks/", cfg.n_groups)):
        gc = {k: v[g] for k, v in cache.items()}
        new = {}
        for i, (mixer, mk) in enumerate(cfg.pattern()):
            b = f"b{i}/"
            x, _, c = _block_apply(x, _sub(gp, b), cfg, mixer, mk,
                                   cache=_sub(gc, b), pos=pos, mode="decode")
            new.update(_under(b, c))
        caches.append(new)
    logits = _unembed(params, x, cfg)
    return logits[:, 0], _stack_groups(caches)


@torch.no_grad()
def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            extra: Optional[dict] = None, pad_to: int = 0):
    """Prefill pass: returns (the last position's logits (B, V), the cache).

    ``pad_to`` grows the self-attention KV caches to this many slots, so
    that the ``decode_step`` calls after it append instead of overwriting
    the ring's earliest slots."""
    logits, _, cache = forward(params, tokens, cfg, extra=extra,
                               mode="prefill", pad_to=pad_to)
    return logits[:, -1], cache
