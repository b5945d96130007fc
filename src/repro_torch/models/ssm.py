"""State-space mixers: Mamba (S6 selective scan) and RWKV-6 (Finch) time-mix
and channel-mix; the port of the JAX package's ``models/ssm.py``. Each
mixer runs a whole sequence (``cache=None``: train and prefill, returning
the prefill cache) or one decode step against its cache.

Mamba's selective scan runs over sequence chunks carrying the SSM state,
with a log-depth (Hillis-Steele) prefix scan inside each chunk. The JAX
package's ``associative_scan`` pairs the elements in another tree, so the
two agree to float32 rounding, not bitwise. Each chunk is recomputed in the
backward, as the JAX package's ``jax.checkpoint`` of the chunk body does:
only the chunk's inputs and its incoming state are kept, not its (Bt,
chunk, di, ds) temporaries. The causal convolution is k
shifted multiply-adds, not ``F.conv1d``: a card's convolution backward is
not bitwise on rerun unless deterministic mode is forced, and the compiled
driver's contract is bitwise reruns. RWKV's wkv recurrence is sequential
over the sequence, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import group_norm_heads, recompute_vjp

F32 = torch.float32


# ================================================================ Mamba


def _ssm_combine(e1, e2):
    """Compose two steps h -> a·h + b, ``e1`` the earlier."""
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


def _prefix_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``_ssm_combine`` along axis 1, log-depth: after the
    step at offset o each element holds the composition of the 2o steps
    ending at it (fewer at the start)."""
    L = a.shape[1]
    off = 1
    while off < L:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        a_cur, b_cur = a[:, off:], b[:, off:]
        na, nb = _ssm_combine((a_prev, b_prev), (a_cur, b_cur))
        a = torch.cat([a[:, :off], na], dim=1)
        b = torch.cat([b[:, :off], nb], dim=1)
        off *= 2
    return a, b


def _chunk_body(h, xc, dt, Bc, Cc, A, D, out_dtype):
    """One chunk of ``selective_scan`` from the state ``h`` (Bt, di, ds),
    in float32. Returns (the chunk's last state, y (Bt, c, di) in
    ``out_dtype``)."""
    xc, dt, Bc, Cc = (t.to(F32) for t in (xc, dt, Bc, Cc))
    a = torch.exp(dt[..., None] * A[None, None])  # (Bt, c, di, ds)
    b = (dt * xc)[..., None] * Bc[:, :, None, :]
    ca, cb = _prefix_scan(a, b)
    h_all = ca * h[:, None] + cb  # (Bt, c, di, ds)
    y = (torch.einsum("bcds,bcs->bcd", h_all, Cc)
         + D[None, None] * xc).to(out_dtype)
    return h_all[:, -1], y


class _Chunk(torch.autograd.Function):
    """``_chunk_body`` that keeps only its inputs for the backward, which
    runs the body again and takes its vector-Jacobian product: the same ops
    on the same values, so the gradients are bitwise those of the body
    differentiated directly."""

    generate_vmap_rule = True

    @staticmethod
    def forward(h, xc, dt, Bc, Cc, A, D, out_dtype):
        h_last, y = _chunk_body(h, xc, dt, Bc, Cc, A, D, out_dtype)
        return h_last.clone(), y  # not a view that keeps h_all alive

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:7])
        ctx.out_dtype = inputs[7]

    @staticmethod
    def backward(ctx, dh, dy):
        return recompute_vjp(lambda *a: _chunk_body(*a, ctx.out_dtype),
                             ctx.saved_tensors, (dh, dy)) + (None,)


def _scan_chunks(body, x, delta, A, B, C, D, h0, chunk):
    """``selective_scan`` with ``body(h, xc, dt, Bc, Cc, A, D, dtype)`` a
    chunk."""
    Bt, L, di = x.shape
    ds = A.shape[1]
    chunk = min(chunk, L)
    h = (torch.zeros((Bt, di, ds), dtype=F32, device=x.device)
         if h0 is None else h0)
    ys = []
    for c0 in range(0, L, chunk):
        h, y = body(h, *(t[:, c0:c0 + chunk] for t in (x, delta, B, C)), A, D,
                    x.dtype)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def selective_scan(x, delta, A, B, C, D, h0=None, chunk: int = 256):
    """h_t = exp(dt*A) h_{t-1} + dt*B_t*x_t ; y_t = C_t . h_t + D*x_t.

    x, delta: (Bt, L, di); A: (di, ds); B, C: (Bt, L, ds); D: (di,).
    Returns (y (Bt,L,di), h_last (Bt,di,ds)). Each chunk is recomputed in
    the backward (``_Chunk``)."""
    return _scan_chunks(_Chunk.apply, x, delta, A, B, C, D, h0, chunk)


def selective_step(x, delta, A, B, C, D, h):
    """One decode step of ``selective_scan``, all in float32. x/delta: (Bt,
    di); B/C: (Bt, ds); h: (Bt, di, ds). Returns (y (Bt, di) in x's dtype,
    the new h)."""
    xf = x.to(F32)
    dt = delta.to(F32)
    a = torch.exp(dt[..., None] * A[None])
    b = (dt * xf)[..., None] * B[:, None, :].to(F32)
    h = a * h + b
    y = torch.einsum("bds,bs->bd", h, C.to(F32)) + D[None] * xf
    return y.to(x.dtype), h


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (Bt, L, di), w: (k, di) -> (Bt, L, di):
    out[t] = sum_i w[i]·x[t - (k-1) + i], the earlier taps first."""
    k, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:L] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + L] * w[i]
    return out + b


def mamba_mixer(x, p, cfg, cache=None, pos=None):
    """Mamba block. x: (Bt, L, D). Without ``cache``, returns (y, the
    prefill cache: conv (Bt, k-1, di), the last k-1 raw conv inputs, left
    padded with zeros when L < k-1, and ssm (Bt, di, ds), the final state).
    With ``cache`` {conv, ssm}, one decode step (L == 1): the window is the
    conv state, cast to x's dtype, and the new input; returns (y, {conv: the
    window's last k-1 inputs, ssm: the new float32 state})."""
    ds = cfg.mamba_d_state
    xz = x @ p["in_proj"]  # (Bt, L, 2*di)
    xi_raw, z = torch.chunk(xz, 2, dim=-1)
    A = -torch.exp(p["A_log"].to(F32))  # (di, ds)
    dt_rank = p["dt_proj"].shape[0]
    if cache is None:
        xi = F.silu(_causal_conv(xi_raw, p["conv_w"], p["conv_b"]))
        dbc = xi @ p["x_proj"]  # (Bt, L, dt_rank + 2*ds)
        dt, Bssm, Cssm = torch.split(dbc, [dt_rank, ds, ds], dim=-1)
        delta = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
        y, h_last = selective_scan(xi, delta, A, Bssm, Cssm, p["D"])
        k = p["conv_w"].shape[0]
        tail = xi_raw[:, -(k - 1):]
        if tail.shape[1] < k - 1:
            tail = F.pad(tail, (0, 0, k - 1 - tail.shape[1], 0))
        new_cache = {"conv": tail, "ssm": h_last}
    else:
        xin = torch.cat([cache["conv"].to(xi_raw.dtype), xi_raw], dim=1)
        xc = F.silu(torch.einsum("bkd,kd->bd", xin, p["conv_w"]) + p["conv_b"])
        dt, Bssm, Cssm = torch.split(xc @ p["x_proj"], [dt_rank, ds, ds], dim=-1)
        delta = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
        yb, h = selective_step(xc, delta, A, Bssm, Cssm, p["D"], cache["ssm"])
        y = yb[:, None]
        new_cache = {"conv": xin[:, 1:], "ssm": h}
    y = y * F.silu(z)
    return y @ p["out_proj"], new_cache


# ================================================================ RWKV-6


def _rwkv_decay(xw, p):
    """Data-dependent per-channel decay: w = exp(-exp(w0 + tanh(x@w1)@w2))."""
    lora = torch.tanh(xw.to(F32) @ p["w1"]) @ p["w2"]
    return torch.exp(-torch.exp(p["w0"] + lora))  # (..., D) in (0,1)


def _rwkv_wkv_scan(r, k, v, w, u, s0):
    """Sequential wkv. r/k/v/w: (Bt, L, H, hd); u: (H, hd); s0: (Bt, H, hd, hd).

    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
    y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)"""
    S, ys = s0, []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]  # (Bt, H, hd)
        kv = kt[..., :, None] * vt[..., None, :]  # (Bt, H, hd, hd)
        ys.append(torch.einsum("bhi,bhij->bhj", rt,
                               S + u[None, :, :, None] * kv))
        S = wt[..., :, None] * S + kv
    return torch.stack(ys, dim=1), S  # (Bt, L, H, hd)


def _shift(x, cache):
    """The previous position's x: zeros before the first, or the cache's
    ``prev`` (Bt, D) in a decode step. x: (Bt, L, D)."""
    if cache is not None:
        return cache["prev"][:, None]
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def rwkv_time_mix(x, p, cfg, cache=None):
    """RWKV-6 time mixing. x: (Bt, L, D) post-norm input; ``cache`` (decode)
    {prev (Bt, D), state (Bt, H, hd, hd)}, else a zero state. Returns (y,
    the new cache: prev x[:, -1], the final float32 state)."""
    Bt, L, Dm = x.shape
    hd = cfg.rwkv_head_dim
    H = Dm // hd
    s0 = (torch.zeros((Bt, H, hd, hd), dtype=F32, device=x.device)
          if cache is None else cache["state"])
    d = _shift(x, cache) - x
    xr = x + d * p["mu_r"]
    xk = x + d * p["mu_k"]
    xv = x + d * p["mu_v"]
    xw = x + d * p["mu_w"]
    xg = x + d * p["mu_g"]
    r = (xr @ p["wr"]).reshape(Bt, L, H, hd)
    k = (xk @ p["wk"]).reshape(Bt, L, H, hd)
    v = (xv @ p["wv"]).reshape(Bt, L, H, hd)
    g = F.silu(xg @ p["wg"])
    w = _rwkv_decay(xw, p).reshape(Bt, L, H, hd)
    u = p["u"].reshape(H, hd)
    rf, kf, vf, wf = (t.to(F32) for t in (r, k, v, w))
    y, S = _rwkv_wkv_scan(rf, kf, vf, wf, u, s0)
    y = group_norm_heads(y, p["ln_x"].reshape(H, hd)).reshape(Bt, L, Dm)
    y = (y.to(x.dtype) * g) @ p["wo"]
    return y, {"prev": x[:, -1], "state": S}


def rwkv_channel_mix(x, p, cache=None):
    """RWKV channel mix. x: (Bt, L, D); ``cache`` (decode) {prev (Bt, D)}.
    Returns (out, the new cache: prev x[:, -1])."""
    d = _shift(x, cache) - x
    xk = x + d * p["mu_k"]
    xr = x + d * p["mu_r"]
    k = torch.square(F.relu(xk @ p["wk"]))
    out = torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])
    return out, {"prev": x[:, -1]}
