"""Unified model configuration for the assigned architecture pool;
counterpart of ``repro/models/config.py``, identical apart from
``torch_dtype``, which takes the place of ``jdtype`` (and also maps
``"float64"``, for gradient checks)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int

    head_dim: int = 0           # 0 -> d_model // n_heads
    window: int = 0             # sliding-window attention (0 = full)
    rope_theta: float = 10_000.0

    # MLA (deepseek)
    kv_lora: int = 0            # compressed joint KV dim; 0 = standard GQA
    rope_dim: int = 64          # decoupled rope sub-dim for MLA

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # dispatch groups (GShard-style): ranking/capacity are computed within
    # each group so the cumsum never crosses data shards (1 = global ranking)
    moe_groups: int = 32

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    expand: int = 2
    ssm_chunk: int = 128
    ssd_bf16: bool = False      # dual-form decay/score matrices in bf16

    # hybrid (zamba2): one *shared* attention block after every k SSM layers
    attn_every: int = 0

    # vlm: every k-th layer is a cross-attention layer over vision embeddings
    cross_every: int = 0
    vision_tokens: int = 0

    # audio enc-dec (whisper): encoder over precomputed frame embeddings
    encoder_layers: int = 0
    encoder_frames: int = 0

    dtype: str = "bfloat16"
    remat: bool = True
    attn_chunk: int = 512       # chunked-attention query block
    # roofline-measurement mode: fully unroll layer scans so XLA cost
    # analysis counts every trip (HLO while bodies are otherwise counted
    # once); used by benchmarks/roofline.py two-point extrapolation
    scan_unroll: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float64": torch.float64}[self.dtype]

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / sliding-window)."""
        return self.family in ("ssm", "hybrid") or self.window > 0

    @property
    def ssm_heads(self) -> int:
        return (self.expand * self.d_model) // self.ssm_head_dim

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (drives roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.hd
        n = self.vocab * d                                  # embedding
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "audio", "hybrid"):
            attn = d * self.n_heads * hd + 2 * d * self.n_kv * hd + self.n_heads * hd * d
            if self.kv_lora:
                attn = (d * self.n_heads * (hd + self.rope_dim)      # q (nope+rope)
                        + d * (self.kv_lora + self.rope_dim)          # kv down
                        + self.kv_lora * self.n_kv * 2 * hd           # kv up
                        + self.n_heads * hd * d)
        if self.family == "ssm":
            n += self.n_layers * self._ssm_layer_params()
        elif self.family == "hybrid":
            n += self.n_layers * self._ssm_layer_params()
            n_attn_blocks = 1  # shared block (reused)
            n += n_attn_blocks * (attn + 3 * d * self.d_ff + 2 * d)
        elif self.family == "moe":
            per_layer = attn + 2 * d
            per_layer += self.n_experts * 3 * d * self.moe_d_ff
            per_layer += self.n_shared_experts * 3 * d * self.moe_d_ff
            per_layer += d * self.n_experts                  # router
            n += self.n_layers * per_layer
        else:
            per_layer = attn + 3 * d * self.d_ff + 2 * d
            n += self.n_layers * per_layer
            if self.family == "audio":
                n += self.encoder_layers * (attn + 3 * d * self.d_ff + 2 * d)
                n += self.n_layers * (attn + d)              # cross attn in decoder
            if self.family == "vlm" and self.cross_every:
                pass  # cross layers counted within n_layers
        n += d  # final norm
        return int(n)

    def _ssm_layer_params(self) -> int:
        d = self.d_model
        d_in = self.expand * d
        nh = self.ssm_heads
        return (d * (2 * d_in + 2 * self.ssm_state + nh)   # in_proj(x,z) + B,C + dt
                + d_in * d + 2 * d + nh)                    # out_proj, norms, A

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        attn = d * self.n_heads * self.hd + 2 * d * self.n_kv * self.hd + self.n_heads * self.hd * d
        if self.kv_lora:
            attn = (d * self.n_heads * (self.hd + self.rope_dim)
                    + d * (self.kv_lora + self.rope_dim)
                    + self.kv_lora * self.n_kv * 2 * self.hd
                    + self.n_heads * self.hd * d)
        per_layer = attn + 2 * d + d * self.n_experts
        per_layer += (self.top_k + self.n_shared_experts) * 3 * d * self.moe_d_ff
        return int(self.vocab * d + self.n_layers * per_layer + d)
