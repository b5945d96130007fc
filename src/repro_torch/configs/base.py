"""Config dataclasses for architectures and input shapes: a copy of the JAX
package's ``configs/base.py`` (plain dataclasses), so that both packages
build the same shapes from the same config."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


# The four assigned input shapes.
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    """One architecture. ``family`` selects the block pattern.

    Layer structure is expressed as a repeated *group pattern*: the
    parameters of the ``n_layers // group_size`` groups are stacked on a
    leading axis and the forward pass loops over the groups; each entry
    of the pattern is ``(mixer, mlp)`` with
    mixer in {'attn', 'cross_attn', 'mamba', 'rwkv'} and
    mlp in {'dense', 'moe', 'moe+dense', 'rwkv_cmix'}.
    """

    arch_id: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention options ---
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    sliding_window: int = 0  # 0 = full attention; >0 = window size
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    moe_every: int = 1  # MoE MLP on layers where (idx % moe_every == moe_every-1)
    dense_residual: bool = False  # Arctic: parallel dense FFN alongside MoE
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_token_group: int = 4096  # GShard token grouping (0 = single group)

    # --- perf knobs (the JAX package's launch/steps.py sets them per mesh) ---
    attn_impl: str = "flash"  # flash | chunked (reference)
    attn_seq_shard: str = ""  # mesh axis to shard the q-seq dim over
    attn_batch_shard: str = ""  # mesh axis the batch dim is sharded over (inference)
    moe_expert_shard: str = ""  # mesh axis for expert parallelism

    # --- hybrid / ssm ---
    attn_every: int = 0  # jamba: 1 attention layer per this many (0 = all attn)
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_conv: int = 4
    rwkv_head_dim: int = 64

    # --- enc-dec (audio) ---
    n_encoder_layers: int = 0
    encoder_seq: int = 0  # stubbed frontend: number of frame embeddings

    # --- vlm ---
    cross_attn_every: int = 0  # every k-th layer is cross-attn
    n_image_tokens: int = 0  # stubbed vision tower: patch embeddings

    # --- misc ---
    tie_embeddings: bool = False
    source: str = ""  # citation
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def group_size(self) -> int:
        """Layers per group."""
        if self.family == "hybrid":
            return self.attn_every
        if self.family == "vlm":
            return self.cross_attn_every
        if self.is_moe and self.moe_every > 1:
            return self.moe_every
        return 1

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.group_size == 0, (self.arch_id, self.n_layers, self.group_size)
        return self.n_layers // self.group_size

    def pattern(self) -> Tuple[Tuple[str, str], ...]:
        """(mixer, mlp) per layer inside one group."""
        g = self.group_size
        out = []
        for i in range(g):
            if self.family == "ssm":
                out.append(("rwkv", "rwkv_cmix"))
                continue
            if self.family == "hybrid":
                mixer = "attn" if i == g - 1 else "mamba"
            elif self.family == "vlm":
                mixer = "cross_attn" if i == g - 1 else "attn"
            else:
                mixer = "attn"
            if self.is_moe and (i % self.moe_every == self.moe_every - 1):
                mlp = "moe+dense" if self.dense_residual else "moe"
            elif self.is_moe and self.moe_every == 1:
                mlp = "moe+dense" if self.dense_residual else "moe"
            else:
                mlp = "dense"
            out.append((mixer, mlp))
        return tuple(out)

    def supports_shape(self, shape: ShapeConfig) -> bool:
        if shape.kind == "decode" and self.family == "audio" and shape.seq_len > 32_768:
            # whisper: encoder context architecturally capped; skip long_500k.
            return False
        return True

    def for_shape(self, shape: ShapeConfig) -> "ModelConfig":
        """Shape-conditional variant: dense/moe/vlm archs use sliding-window
        self-attention for long-context decode (sub-quadratic requirement)."""
        if (
            shape.kind == "decode"
            and shape.seq_len > 100_000
            and self.family in ("dense", "moe", "vlm")
            and self.sliding_window == 0
        ):
            return dataclasses.replace(self, sliding_window=8192)
        return self

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks), for roofline."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        n_mlp = 3 if self.act == "swiglu" else 2
        total = v * d * (1 if self.tie_embeddings else 2)
        for mixer, mlp in self.pattern() * self.n_groups:
            if mixer in ("attn", "cross_attn"):
                total += d * hd * (H + 2 * KV) + H * hd * d
            elif mixer == "mamba":
                di = self.mamba_expand * d
                total += d * 2 * di + di * (2 * self.mamba_d_state + 1) + di * d
            elif mixer == "rwkv":
                total += 4 * d * d + 3 * d * d // 8  # r,k,v,o + low-rank decay/mix approx
            if mlp == "dense":
                total += n_mlp * d * ff
            elif mlp in ("moe", "moe+dense"):
                total += self.n_experts * n_mlp * d * ff + d * self.n_experts
                if self.n_shared_experts:
                    total += n_mlp * d * self.shared_d_ff
                if mlp == "moe+dense":
                    total += n_mlp * d * ff
            elif mlp == "rwkv_cmix":
                total += 2 * d * ff + d * d
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (4 * d * hd * H + n_mlp * d * ff)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if not self.is_moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        n_mlp = 3 if self.act == "swiglu" else 2
        dead = 0
        for _, mlp in self.pattern() * self.n_groups:
            if mlp in ("moe", "moe+dense"):
                dead += (self.n_experts - self.top_k) * n_mlp * d * ff
        return self.param_count() - dead


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 256) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (≤4 experts, d≤512)."""
    d_model = min(d_model, 512)
    g = cfg.group_size
    n_layers = max(n_layers, g)
    n_layers = (n_layers // g) * g or g
    hd = 32
    n_heads = max(2, d_model // (2 * hd))
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    if cfg.n_kv_heads == cfg.n_heads:  # MHA archs stay MHA
        n_kv = n_heads
    repl = dict(
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=hd,
        d_ff=2 * d_model,
        vocab_size=512,
        mamba_d_state=8,
    )
    if cfg.is_moe:
        repl.update(n_experts=4, top_k=min(2, cfg.top_k), shared_d_ff=d_model,
                    n_shared_experts=min(1, cfg.n_shared_experts),
                    capacity_factor=2.0)
    if cfg.n_encoder_layers:
        repl.update(n_encoder_layers=2, encoder_seq=16)
    if cfg.n_image_tokens:
        repl.update(n_image_tokens=16)
    return dataclasses.replace(cfg, **repl)
