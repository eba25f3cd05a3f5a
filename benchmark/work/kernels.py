"""Least time of K1 (MSDA forward), K2 (MSDA backward) and K3 (Swin window
attention) at a call's shapes: the larger of its operations over the peak
and its bytes over HBM bandwidth. Every input read once, every output
written once.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit. MSDA's
bilinear sampling runs on the CUDA cores (the float32 rate); K3's two
matmuls on the tensor cores (the bf16 rate, or the float32 rate for a float32
call).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12


def least_s(flops: float, nbytes: float, flops_per_s: float) -> float:
    return max(flops / flops_per_s, nbytes / HBM_BYTES_PER_S)


def msda_fwd(B: int, S: int, M: int, D: int, Lq: int, L: int, P: int, value_bytes: int,
             attn_bytes: int) -> float:
    """K1: value, float32 locations and the weights read once, the output
    (value's dtype) written once; 2 flops per channel for each of a sample's
    4 bilinear corners. Seconds."""
    nbytes = (B * S * M * D * value_bytes + B * Lq * M * L * P * 2 * 4
              + B * Lq * M * L * P * attn_bytes + B * Lq * M * D * value_bytes)
    return least_s(2.0 * D * 4 * B * Lq * M * L * P, nbytes, F32_FLOPS)


def msda_bwd(B: int, S: int, M: int, D: int, Lq: int, L: int, P: int, value_bytes: int,
             attn_bytes: int) -> float:
    """K2: value, locations, weights and the cotangent read once; d_value,
    d_loc and d_attn written once in their inputs' dtypes; 4 flops per channel
    for each of a sample's 4 corners (the dot with the cotangent, the scaled
    scatter). Seconds."""
    nbytes = (2 * (B * S * M * D * value_bytes + B * Lq * M * L * P * 2 * 4
                   + B * Lq * M * L * P * attn_bytes) + B * Lq * M * D * value_bytes)
    return least_s(4.0 * D * 4 * B * Lq * M * L * P, nbytes, F32_FLOPS)


def window_attention(B_: int, H: int, N: int, Dh: int, elem_bytes: int,
                     masked_windows: int = 0) -> float:
    """K3: q, k, v read and the output written in their dtype, the float32
    (H, N, N) bias and the int32 (nW, N) region ids read once; 4 N^2 Dh flops
    per (window, head). Seconds."""
    nbytes = 4 * B_ * H * N * Dh * elem_bytes + H * N * N * 4 + masked_windows * N * 4
    rate = BF16_TC_FLOPS if elem_bytes == 2 else F32_FLOPS
    return least_s(4.0 * B_ * H * N * N * Dh, nbytes, rate)

