"""Primitive layers: norms (and RWKV's per-head groupnorm), RoPE, chunked
(online-softmax) attention, single-token attention against a KV cache,
MLPs; the port of the JAX package's ``models/layers.py``, function for
function; and ``recompute_vjp``, the backward of the port's recomputing
``autograd.Function``s (the JAX package's ``jax.checkpoint``).

Attention is the JAX package's online-softmax loop over KV chunks (and over
query chunks), written as Python loops over plain tensor code: no library
attention kernel, whose backward is not guaranteed deterministic. Products
take float32 operands, as JAX's ``preferred_element_type=float32`` sums in
float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32
NEG_INF = -1e30

# ---------------------------------------------------------------- norms


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(F32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(F32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * scale + bias).to(dtype)


def apply_norm(x, p, kind: str):
    """``p``: the norm's {"scale"[, "bias"]}."""
    if kind == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def group_norm_heads(x: torch.Tensor, scale: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Per-head groupnorm of the RWKV time-mix output. x: (..., H, hd),
    scale: (H, hd)."""
    dtype = x.dtype
    x = x.to(F32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * scale).to(dtype)


# ---------------------------------------------------------------- RoPE


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> cos/sin of shape (..., head_dim//2)."""
    half = head_dim // 2
    ar = torch.arange(half, dtype=F32, device=positions.device)
    freqs = 1.0 / (theta ** (ar / half))
    ang = positions.to(F32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (S, hd//2) or broadcastable."""
    dtype = x.dtype
    x = x.to(F32)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    # broadcast cos/sin over batch/head axes: (S, half) -> (1, S, 1, half)
    while cos.dim() < x1.dim():
        cos, sin = cos[None], sin[None]
        if cos.dim() == x1.dim() - 1:  # insert head axis before last
            cos, sin = cos.unsqueeze(-2), sin.unsqueeze(-2)
            break
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


# ---------------------------------------------------------------- attention


def _attn_chunk(qc, kc, vc, qpos, kpos, *, causal, window, scale, m, l, acc,
                kv_len=None):
    """One online-softmax update. qc: (B,Q,KV,G,hd) kc/vc: (B,S,KV,hd).

    The running max only keeps the exponents in range: the result does not
    depend on it, so it carries no gradient (as in the JAX package's
    recomputing backward, ``flash.py``)."""
    s = torch.einsum("bqkgd,bskd->bkgqs", qc.to(F32), kc.to(F32)) * scale
    mask = kpos[None, :] >= 0
    if kv_len is not None:
        mask = kpos[None, :] < kv_len
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window:
        mask = mask & (kpos[None, :] > (qpos[:, None] - window))
    s = torch.where(mask[None, None, None], s, NEG_INF)
    m_new = torch.maximum(m, torch.amax(s, dim=-1)).detach()
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + torch.sum(p, dim=-1)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vc.dtype).to(F32), vc.to(F32))
    acc_new = acc * corr[..., None] + pv
    return m_new, l_new, acc_new


def _pad_seq(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad axis 1 of (B, S, ...) to n."""
    if n == x.shape[1]:
        return x
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, n - x.shape[1]))


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Flash-style attention. q: (B,Sq,H,hd), k/v: (B,Skv,KV,hd) -> (B,Sq,H,hd).

    GQA via reshaping q heads into (KV, G); ``window`` > 0 keeps the keys of
    the last ``window`` positions (sliding window). Memory is O(chunk^2),
    not O(S^2)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    qc_n = min(q_chunk, Sq)
    kc_n = min(kv_chunk, Skv)
    Sq_p = -(-Sq // qc_n) * qc_n
    Skv_p = -(-Skv // kc_n) * kc_n
    qp = _pad_seq(q, Sq_p).reshape(B, Sq_p // qc_n, qc_n, KV, G, hd)
    kp = _pad_seq(k, Skv_p).reshape(B, Skv_p // kc_n, kc_n, KV, hd)
    vp = _pad_seq(v, Skv_p).reshape(B, Skv_p // kc_n, kc_n, KV, hd)
    dev = q.device
    outs = []
    for qi in range(Sq_p // qc_n):
        qcb = qp[:, qi]  # (B, qc, KV, G, hd)
        qpos = q_offset + qi * qc_n + torch.arange(qc_n, device=dev)
        m = torch.full((B, KV, G, qc_n), NEG_INF, dtype=F32, device=dev)
        l = torch.zeros((B, KV, G, qc_n), dtype=F32, device=dev)
        acc = torch.zeros((B, KV, G, qc_n, hd), dtype=F32, device=dev)
        for ki in range(Skv_p // kc_n):
            kpos = ki * kc_n + torch.arange(kc_n, device=dev)
            m, l, acc = _attn_chunk(
                qcb, kp[:, ki], vp[:, ki], qpos, kpos, causal=causal,
                window=window, scale=scale, m=m, l=l, acc=acc, kv_len=Skv)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        # (B, KV, G, qc, hd) -> (B, qc, KV*G, hd)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, qc_n, H, hd)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)[:, :Sq]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length_mask: torch.Tensor = None) -> torch.Tensor:
    """Single-token attention against a KV cache. q: (B, 1, H, hd),
    k_cache/v_cache: (B, S, KV, hd), length_mask: (B, S) bool, True = valid
    -> (B, 1, H, hd) in q's dtype. GQA via reshaping q heads into (KV, G).
    The scores sum in float32; the probabilities are cast to the cache's
    dtype before P·V, which sums in float32, as in the JAX package."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    qh = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qh.to(F32), k_cache.to(F32)) * scale
    if length_mask is not None:
        s = torch.where(length_mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).to(F32),
                       v_cache.to(F32))
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------- MLP


def mlp(x: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    """``p``: {"w1", "w2"[, "w3"][, "b1"][, "b2"]}; swiglu or (tanh) gelu,
    ``jax.nn.gelu``'s default."""
    if act == "swiglu":
        h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    else:
        h = F.gelu(x @ p["w1"] + p.get("b1", 0), approximate="tanh")
    out = h @ p["w2"]
    if "b2" in p:
        out = out + p["b2"]
    return out


# ---------------------------------------------------------------- recompute


def recompute_vjp(fn, inputs, cotangents):
    """The vector-Jacobian product of ``fn`` at ``inputs`` (a tuple of
    tensors) against ``cotangents`` (one a tensor ``fn`` returns), with
    ``fn`` run again: the backward of a Function that keeps only its
    inputs. Call it as the backward finds the grad mode, which autograd sets
    to its ``create_graph``: the inner backward then picks the derivative
    formulas the outer one does (some ops, ``silu`` among them, have a
    fused one and a differentiable one), so the gradients are bitwise those
    of ``fn`` differentiated in place. Everything is detached from the
    outer graph first, so with ``create_graph=True`` (``torch.func.grad``)
    nothing of the recompute is recorded for a second derivative."""
    _, vjp = torch.func.vjp(fn, *(t.detach() for t in inputs))
    return vjp(tuple(t.detach() for t in cotangents))
