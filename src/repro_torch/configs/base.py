"""ArchConfig: the LM architectures the repo ships, as data.

The port's copy of the JAX package's ``configs/base.py``: the same fields,
defaults and ``param_count``, with ``torch.float32`` as the parameter and
compute type. ``InputShape``/``INPUT_SHAPES`` are the four assigned global
shapes. Which archs the port runs is decided by ``models.factory.build``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
VLM = "vlm"
AUDIO = "audio"

VOCAB_PAD = 256  # pad vocab to a multiple of 256


def pad_vocab(v: int) -> int:
    return int(math.ceil(v / VOCAB_PAD) * VOCAB_PAD)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                    # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    n_heads: int                      # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                   # 0 -> d_model // n_heads
    source: str = ""

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # --- MLA (DeepSeek-V2) ---
    kv_lora_rank: int = 0             # 0 -> standard GQA attention
    rope_head_dim: int = 64

    # --- SSM (Mamba2 / Zamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    attn_every: int = 0               # hybrid: shared attn every k layers

    # --- modality stubs ---
    is_encoder_decoder: bool = False  # audio (whisper): enc-dec split
    vision_prefix_frac: float = 0.0   # vlm: share of seq as patch embeds

    # --- misc ---
    gated_mlp: bool = True            # swiglu (3 mats) vs gelu (2 mats)
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int = 4096        # ring-buffer KV cache capacity / window
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count; ``active_only`` counts top-k routed
        experts only (MoE 6·N_active·D convention)."""
        d, v = self.d_model, self.padded_vocab
        n = v * d  # token embedding
        if not self.tie_embeddings:
            n += v * d  # lm head
        per_layer = 0
        if self.has_attention:
            hd, H, KV = self.head_dim, self.n_heads, self.n_kv_heads
            if self.kv_lora_rank:
                r, rd = self.kv_lora_rank, self.rope_head_dim
                per_attn = (d * H * (hd + rd)       # q (nope+rope)
                            + d * (r + rd)          # kv down + k_rope
                            + r * H * hd * 2        # k/v up
                            + H * hd * d)           # out
            else:
                per_attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        ffn = (3 if self.gated_mlp else 2) * d * self.d_ff if self.d_ff else 0
        if self.arch_type in (SSM,):
            ssm = (d * 2 * self.d_inner                 # in_proj (x, z)
                   + d * 2 * self.ssm_state             # B, C proj
                   + d * self.ssm_heads                 # dt proj
                   + self.d_inner * d)                  # out proj
            per_layer = ssm
            n += self.num_layers * per_layer
            return n
        if self.arch_type == HYBRID:
            ssm = (d * 2 * self.d_inner + d * 2 * self.ssm_state
                   + d * self.ssm_heads + self.d_inner * d)
            n += self.num_layers * ssm
            # ONE shared attention block (attn + MLP), Zamba weight sharing
            n += per_attn + ffn
            return n
        if self.arch_type == MOE:
            n_routed = self.n_experts if not active_only else self.top_k
            moe_ffn = 3 * d * self.d_ff * (n_routed + self.n_shared_experts)
            router = d * self.n_experts
            per_layer = per_attn + moe_ffn + router
        else:  # dense / vlm / audio
            per_layer = per_attn + ffn
        layers = self.num_layers * (2 if self.is_encoder_decoder else 1)
        if self.is_encoder_decoder:
            per_layer += per_attn  # decoder cross-attention
        n += layers * per_layer
        return n


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
