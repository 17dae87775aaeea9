"""Analytic FLOPs/bytes model of the roofline terms: the port of the JAX
package's ``launch/roofline_model.py``, over the port's own ``configs``
(``ArchConfig.param_count``, ``padded_vocab``, ``INPUT_SHAPES``), and the
H100 peaks that the roofline and ``chip_smoke.py``'s bounds divide by.

The counts are exact analytic matmul counts of a step, the same numbers as
the JAX module's for every arch and input shape. In eager PyTorch every
layer and microbatch loop runs, so nothing counts a loop body once (the
reason the JAX package counts analytically); the model is kept for the
same numbers on both sides and for the share of an LM step's roofline that
a measured time reaches (``chip_smoke.py``'s ``roofline_phase``).

All numbers are GLOBAL per step (divide by chips for per-chip seconds).
"""
from __future__ import annotations

import dataclasses

from ..configs.base import HYBRID, MOE, SSM, ArchConfig, InputShape

# The card the peaks are for: NVIDIA H100 SXM5 80 GB at its 700 W limit.
# Each entry names its source. A card set below 700 W runs slower under
# load, so every time measured against these carries the card's name and
# power limit.
H100_SXM = {
    # HBM3 bandwidth: H100 data sheet (SXM5), 3.35 TB/s
    "hbm_bytes_per_s": 3.35e12,
    # FP32 on the CUDA cores, dense: H100 data sheet (SXM5), 67 TFLOP/s
    "fp32_flops": 67e12,
    # BF16 on the tensor cores, dense: H100 data sheet (SXM5), 989 TFLOP/s
    # (its 1,979 is with 2:4 sparsity)
    "bf16_flops": 989e12,
    # INT32 on the CUDA cores: the Hopper architecture white paper's 64
    # INT32 lanes per SM x 132 SMs x the 1.98 GHz boost clock that the
    # FP32 figure assumes
    "int32_ops": 132 * 64 * 1.98e9,
    # NVLink 4, one direction: H100 data sheet (SXM5), 900 GB/s
    # bidirectional per GPU
    "nvlink_bytes_per_s": 450e9,
}
# 32-bit integer operations of one threefry draw in csrc/int8_quant.cu:
# counter add 1, 20 x (add, rotate, xor), 5 x 2 key-injection adds, the
# output xor, the uniform's shift and or
THREEFRY_INT_OPS = 1 + 20 * 3 + 5 * 2 + 1 + 2


BF16 = 2
FP32 = 4


def peak_flops(dtype: str = "fp32") -> float:
    """The H100's compute peak for a compute dtype: 'fp32' (strict f32 on
    the CUDA cores, the port's parity contract) or 'bf16' (tensor
    cores)."""
    return H100_SXM[{"fp32": "fp32_flops", "bf16": "bf16_flops"}[dtype]]


# --------------------------------------------------------------------------
# FLOPs
# --------------------------------------------------------------------------

def attn_flops_fwd(cfg: ArchConfig, tokens_sq_pairs: float) -> float:
    """Score+context matmuls: 4 · pairs · H · head_dim (2 matmuls, 2 flops)."""
    if not cfg.has_attention:
        return 0.0
    hd = cfg.head_dim + (cfg.rope_head_dim if cfg.kv_lora_rank else 0)
    return 4.0 * tokens_sq_pairs * cfg.n_heads * hd


def _attn_pairs(b: float, s: float, *, causal=True, window=None) -> float:
    """Number of (q, kv) attended pairs."""
    if window is not None and window < s:
        return b * (s * window - window * (window - 1) / 2.0)
    return b * (s * (s + 1) / 2.0 if causal else s * s)


def _n_attn_layers(cfg: ArchConfig) -> float:
    if cfg.arch_type == SSM:
        return 0
    if cfg.arch_type == HYBRID:
        return -(-cfg.num_layers // cfg.attn_every)   # shared block call sites
    if cfg.is_encoder_decoder:
        return 3 * cfg.num_layers                     # enc self + dec self + cross
    return cfg.num_layers


def _ssd_flops_fwd(cfg: ArchConfig, b: float, s: float) -> float:
    """Chunked SSD per layer: intra-chunk (Q² terms) + state terms."""
    if cfg.arch_type not in (SSM, HYBRID):
        return 0.0
    q = cfg.ssm_chunk
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    nc = max(1, s // q)
    per_chunk = (2 * q * q * n            # G = C Bᵀ
                 + 2 * h * q * q * p      # (G⊙L) @ x
                 + 2 * h * q * n * p * 2)  # states in + out
    return b * nc * per_chunk


def step_flops(cfg: ArchConfig, shape: InputShape) -> dict:
    """Returns dict with 'total', 'ideal' (causal-skipping attention) and
    'xla_fallback' (masked full-matrix attention = what the compiled XLA
    graph actually computes — the Pallas kernel achieves 'ideal')."""
    b, s = shape.global_batch, shape.seq_len
    n_active = cfg.param_count(active_only=True)
    tokens = b * s

    if shape.kind in ("train", "prefill"):
        dense_fwd = 2.0 * n_active * tokens
        la = _n_attn_layers(cfg)
        window = cfg.sliding_window if (shape.name == "long_500k") else None
        if cfg.is_encoder_decoder:
            # enc bidir on s/2, dec causal on s/2, cross s/2×s/2
            pairs_i = (_attn_pairs(b, s / 2, causal=False)
                       + _attn_pairs(b, s / 2, causal=True)
                       + b * (s / 2) ** 2)
            pairs_x = pairs_i
        else:
            pairs_i = la * _attn_pairs(b, s, causal=True, window=window)
            pairs_x = la * _attn_pairs(b, s, causal=False)  # masked fallback
        attn_i = attn_flops_fwd(cfg, pairs_i)
        attn_x = attn_flops_fwd(cfg, pairs_x)
        ssd = cfg.num_layers * _ssd_flops_fwd(cfg, b, s)
        if shape.kind == "prefill":
            return {"ideal": dense_fwd + attn_i + ssd,
                    "xla_fallback": dense_fwd + attn_x + ssd,
                    "dense": dense_fwd}
        # train: fwd + bwd(2×) + remat re-fwd(1×) = 4× fwd
        return {"ideal": 4 * (dense_fwd + attn_i + ssd),
                "xla_fallback": 4 * (dense_fwd + attn_x + ssd),
                "dense": 6 * n_active * tokens}

    # decode: one token per sequence
    if cfg.arch_type == MOE:
        # moe_dense decode path computes ALL experts (see models/moe.py)
        n_all = cfg.param_count(active_only=False)
        dense = 2.0 * n_all * b
        dense_ideal = 2.0 * n_active * b
    else:
        dense = dense_ideal = 2.0 * n_active * b
    cache_len = min(s, cfg.sliding_window) if shape.name == "long_500k" \
        else s
    la = _n_attn_layers(cfg)
    attn = attn_flops_fwd(cfg, la * b * cache_len)
    if cfg.is_encoder_decoder:
        attn = attn_flops_fwd(cfg, cfg.num_layers * b * (cache_len + 4096))
    ssd = 0.0
    if cfg.arch_type in (SSM, HYBRID):
        h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        ssd = cfg.num_layers * b * (4.0 * h * n * p)
    return {"ideal": dense_ideal + attn + ssd,
            "xla_fallback": dense + attn + ssd,
            "dense": dense}


# --------------------------------------------------------------------------
# HBM bytes (global per step)
# --------------------------------------------------------------------------

def step_bytes(cfg: ArchConfig, shape: InputShape, *, grad_accum: int = 1,
               param_bytes: int = FP32, act_bytes: int = BF16) -> dict:
    b, s = shape.global_batch, shape.seq_len
    n_params = cfg.param_count()
    n_active = cfg.param_count(active_only=True)
    d, L = cfg.d_model, cfg.num_layers

    if shape.kind == "train":
        tokens = b * s
        # weights streamed per microbatch: fwd + remat-refwd + bwd
        w = 3.0 * grad_accum * n_params * act_bytes
        g = 3.0 * n_params * FP32            # grad write+read, param update
        acts = 4.0 * L * tokens * d * act_bytes  # residual save+load, fwd+bwd
        logits = 2.0 * tokens * cfg.padded_vocab * act_bytes / max(grad_accum, 1)
        return {"total": w + g + acts + logits, "weights": w, "acts": acts}
    if shape.kind == "prefill":
        tokens = b * s
        w = n_params * act_bytes
        acts = 2.0 * L * tokens * d * act_bytes
        return {"total": w + acts, "weights": w, "acts": acts}

    # decode
    if cfg.arch_type == MOE:
        w = n_params * act_bytes              # dense decode path reads all
        w_ideal = (n_active + (n_params - n_active) * min(
            1.0, b * cfg.top_k / max(cfg.n_experts, 1))) * act_bytes
    else:
        w = w_ideal = n_params * act_bytes
    cache_len = min(s, cfg.sliding_window) if shape.name == "long_500k" else s
    if cfg.kv_lora_rank:
        per_tok = cfg.kv_lora_rank + cfg.rope_head_dim
    elif cfg.has_attention:
        per_tok = 2 * cfg.n_kv_heads * cfg.head_dim
    else:
        per_tok = 0
    la = _n_attn_layers(cfg)
    cache = la * b * cache_len * per_tok * act_bytes
    state = 0.0
    if cfg.arch_type in (SSM, HYBRID):
        state = 2.0 * L * b * cfg.ssm_heads * cfg.ssm_state \
            * cfg.ssm_head_dim * act_bytes
    return {"total": w + cache + state, "weights": w, "cache": cache + state,
            "weights_ideal": w_ideal}


def conv_tile_rows(w_img: int, qp: int, cp: int) -> int:
    """Rows a block of ``csrc/conv_fused.cu`` owns with the pool, for
    images of width ``w_img``, patch width ``qp`` and ``cp`` output
    channels.

    The JAX function sizes a Pallas row tile to a TPU VMEM budget (4 MiB
    of f32 tiles), which has no counterpart on the card: the CUDA kernel's
    GEMM tile is BM = 32·TM rows, TM = 14 when C > 32 (448 rows), else 8
    (256), whatever the patch width (``qp`` is kept for the JAX
    signature). Its rule instead (``conv_fused.cu``, ``launch``): a block
    owns whole pairs of image rows, the largest multiple of 2·w_img that
    fits in BM, or 2·w_img rows taken in passes of BM when one pair is
    wider than the tile. Both rules promise a multiple of 2·w_img, so no
    2×2 pool window straddles two blocks; the numbers differ."""
    del qp
    bm = 32 * (14 if cp > 32 else 8)
    gran = 2 * w_img
    return bm // gran * gran if gran <= bm else gran


@dataclasses.dataclass
class AnalyticRoofline:
    flops_ideal: float
    flops_xla: float
    hbm_bytes: float
    model_flops: float     # 6·N_active·D convention


def analytic_roofline(cfg: ArchConfig, shape: InputShape, *,
                      grad_accum: int = 1) -> AnalyticRoofline:
    fl = step_flops(cfg, shape)
    by = step_bytes(cfg, shape, grad_accum=grad_accum)
    return AnalyticRoofline(flops_ideal=fl["ideal"],
                            flops_xla=fl["xla_fallback"],
                            hbm_bytes=by["total"],
                            model_flops=fl["dense"])
