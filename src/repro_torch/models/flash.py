"""Memory-optimal attention: an online softmax over KV chunks whose backward
recomputes the probabilities; the port of the JAX package's
``models/flash.py`` (its ``custom_vjp``) as a ``torch.autograd.Function``.

Autograd of ``layers.chunked_attention`` keeps every (Sq, kv_chunk) score
block of every chunk pair for the backward pass; this function keeps only
(q, k, v, out, lse) and recomputes each block's probabilities from the
log-sum-exp, the FlashAttention recipe in plain tensor code. The forward is
the JAX package's loop over KV chunks with the whole query sequence in one
block; the backward forms ``ds = p·(dp − rowsum(dO∘O))·scale`` in its order.
Products take float32 operands, as JAX's ``preferred_element_type=float32``
sums in float32.

The function runs under ``torch.func.vmap(torch.func.grad(...))`` (its vmap
rule is generated: the forward and backward are plain tensor code over
Python-int arguments) and inside CUDA-graph capture (no host sync, no
nested autograd in the backward). It takes no second derivative: its
backward runs without recording a graph. The JAX package's mesh arguments
(``shard_axis``, ``batch_axis``) are sharding hints there
(``with_sharding_constraint``) that never change a value; the port's
sharded paths compute a 'model' group's work on every rank of the group,
so here they are accepted and change nothing. Splitting the attention's
work over 'model' is the tensor-parallel forward (ROADMAP.md queue 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32
NEG_INF = -1e30


def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad axis 1 of (B, S, ...) to n."""
    if n == x.shape[1]:
        return x
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, n - x.shape[1]))


def _mask(qpos, kpos, causal: bool, window: int, kv_valid: int):
    m = kpos[None, :] < kv_valid
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    if window:
        m = m & (kpos[None, :] > (qpos[:, None] - window))
    return m  # (Sq, kc)


def _geometry(q, k, kv_chunk: int):
    """(B, Sq, H, hd, Skv, KV, G, scale, kc, Skp, nk) of a call."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    kc = min(kv_chunk, Skv)
    Skp = -(-Skv // kc) * kc
    return B, Sq, H, hd, Skv, KV, H // KV, 1.0 / (hd ** 0.5), kc, Skp, Skp // kc


def _heads(x, B, Sq, KV, G, hd):
    """(B, Sq, H, hd) -> (B, KV, G, Sq, hd)."""
    return x.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)


def _scores(qh, kc, qpos, kpos, causal, window, Skv, scale):
    s = torch.einsum("bkgqd,bskd->bkgqs", qh.to(F32), kc.to(F32)) * scale
    msk = _mask(qpos, kpos, causal, window, Skv)
    return torch.where(msk[None, None, None], s, NEG_INF)


def _fwd_impl(q, k, v, causal, window, q_offset, kv_chunk):
    B, Sq, H, hd, Skv, KV, G, scale, kc, Skp, nk = _geometry(q, k, kv_chunk)
    qh = _heads(q, B, Sq, KV, G, hd)
    kp = _pad_to(k, Skp).reshape(B, nk, kc, KV, hd)
    vp = _pad_to(v, Skp).reshape(B, nk, kc, KV, hd)
    dev = q.device
    qpos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=F32, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=F32, device=dev)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=F32, device=dev)
    for ki in range(nk):
        kpos = ki * kc + torch.arange(kc, device=dev)
        s = _scores(qh, kp[:, ki], qpos, kpos, causal, window, Skv, scale)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).to(F32),
                          vp[:, ki].to(F32))
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B,KV,G,Sq,hd)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
    return out, lse


def _bwd_impl(q, k, v, out, lse, dout, causal, window, q_offset, kv_chunk):
    B, Sq, H, hd, Skv, KV, G, scale, kc, Skp, nk = _geometry(q, k, kv_chunk)
    qh = _heads(q, B, Sq, KV, G, hd)
    doh = _heads(dout, B, Sq, KV, G, hd).to(F32)
    oh = _heads(out, B, Sq, KV, G, hd).to(F32)
    kp = _pad_to(k, Skp).reshape(B, nk, kc, KV, hd)
    vp = _pad_to(v, Skp).reshape(B, nk, kc, KV, hd)
    dev = q.device
    qpos = q_offset + torch.arange(Sq, device=dev)
    drow = torch.sum(doh * oh, dim=-1)  # (B,KV,G,Sq)
    dq = torch.zeros((B, KV, G, Sq, hd), dtype=F32, device=dev)
    dks, dvs = [], []
    for ki in range(nk):
        kpos = ki * kc + torch.arange(kc, device=dev)
        s = _scores(qh, kp[:, ki], qpos, kpos, causal, window, Skv, scale)
        p = torch.exp(s - lse[..., None])  # recomputed probabilities
        dp = torch.einsum("bkgqd,bskd->bkgqs", doh.to(v.dtype).to(F32),
                          vp[:, ki].to(F32))
        ds = p * (dp - drow[..., None]) * scale
        dq = dq + torch.einsum("bkgqs,bskd->bkgqd", ds.to(k.dtype).to(F32),
                               kp[:, ki].to(F32))
        dks.append(torch.einsum("bkgqs,bkgqd->bskd", ds.to(q.dtype).to(F32),
                                qh.to(F32)))
        dvs.append(torch.einsum("bkgqs,bkgqd->bskd", p, doh))
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    dk = torch.cat(dks, dim=1)[:, :Skv]
    dv = torch.cat(dvs, dim=1)[:, :Skv]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """(q, k, v) -> (out, lse); saves (q, k, v, out, lse)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, causal, window, q_offset, kv_chunk):
        return _fwd_impl(q, k, v, causal, window, q_offset, kv_chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, q_offset, kv_chunk = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_offset, kv_chunk)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        # torch.func.grad runs the backward with create_graph=True, which
        # would keep every chunk's recomputed score blocks for a second
        # derivative until the gradient is returned: nothing takes one
        with torch.no_grad():
            dq, dk, dv = _bwd_impl(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_chunk: int = 1024, shard_axis: str = "",
                    batch_axis: str = "") -> torch.Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Skv,KV,hd) -> (B,Sq,H,hd). GQA via reshaping
    the q heads into (KV, G); ``window`` > 0 keeps the keys of the last
    ``window`` positions; the query at row i sits at position q_offset + i;
    the keys are padded to a multiple of ``kv_chunk`` and masked there.
    ``shard_axis`` / ``batch_axis`` (the mesh axes of the q-sequence and
    batch dims) are placements with no effect on the values (module
    docstring)."""
    out, _ = _FlashAttention.apply(q, k, v, bool(causal), int(window),
                                   int(q_offset), int(kv_chunk))
    return out
