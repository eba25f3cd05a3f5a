"""Multi-scale deformable attention (MSDA): the plain PyTorch version and the
wrapper of its hand-written CUDA kernel (`csrc/ms_deform_attn_fwd.cu`).

Semantics (neurips2023_soc_tpu/ops/ms_deform_attn.py): for every (batch,
query, head), sample `P` bilinear points from each of `L` flattened feature
levels at `sampling_locations` (normalized [0, 1] xy; pixel coordinate
`x = loc_x * W_l - 0.5`, grid_sample align_corners=False) and reduce them with
`attention_weights`. Every corner outside its level has zero weight, size-1
levels included. Sums run in float32; the output has the value's dtype.

Shapes (channels-last, head-major), as in the JAX package:
  value:               (B, S, M, D)   S = sum(H_l * W_l)
  spatial_shapes:      ((H_0, W_0), ..., (H_{L-1}, W_{L-1}))
  sampling_locations:  (B, Lq, M, L, P, 2)  float32
  attention_weights:   (B, Lq, M, L, P)
  returns:             (B, Lq, M * D)

`ms_deform_attn` sends a CPU tensor to `ms_deform_attn_torch` and a CUDA
tensor to the kernel; it never falls back from one to the other.

Rounding: the JAX XLA path rounds each bf16 `value * weight` product to bf16
before its float32 sum (neurips2023_soc_tpu/ops/ms_deform_attn.py:202-204);
the kernel and the plain version here keep the product in float32. So on the
card the kernel is held against the plain version, not against JAX.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build

SpatialShapes = Tuple[Tuple[int, int], ...]


def level_start_index(spatial_shapes: SpatialShapes) -> Tuple[int, ...]:
    starts, cur = [], 0
    for h, w in spatial_shapes:
        starts.append(cur)
        cur += h * w
    return tuple(starts)


def ms_deform_attn_torch(
    value: torch.Tensor,
    spatial_shapes: SpatialShapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version: direct 4-corner bilinear sampling with zero
    padding, accumulated in float32."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if L != len(spatial_shapes):
        raise ValueError(f"{L} levels in the locations, {len(spatial_shapes)} shapes")
    starts = level_start_index(spatial_shapes)
    loc = sampling_locations.float()
    attn = attention_weights.float()
    vh = value.float().permute(0, 2, 1, 3)  # (B, M, S, D)
    out = torch.zeros(B, M, Lq, D, dtype=torch.float32, device=value.device)
    for l, (H, W) in enumerate(spatial_shapes):
        x = loc[:, :, :, l, :, 0] * W - 0.5  # (B, Lq, M, P)
        y = loc[:, :, :, l, :, 1] * H - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx, fy = x - x0, y - y0
        a = attn[:, :, :, l]
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            for dx, wx in ((0, 1.0 - fx), (1, fx)):
                xi = x0 + dx
                yi = y0 + dy
                inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
                w = torch.where(inside, wy * wx * a, torch.zeros_like(a))
                idx = (starts[l] + yi.clamp(0, H - 1) * W
                       + xi.clamp(0, W - 1)).long()
                idx = idx.permute(0, 2, 1, 3).reshape(B, M, Lq * P, 1)
                g = torch.gather(vh, 2, idx.expand(B, M, Lq * P, D))
                g = g.view(B, M, Lq, P, D)
                out += (g * w.permute(0, 2, 1, 3)[..., None]).sum(3)
    return out.permute(0, 2, 1, 3).reshape(B, Lq, M * D).to(value.dtype)


def _check(value, spatial_shapes, loc, attn):
    if value.device.type != "cuda":
        raise ValueError(f"the MSDA kernel takes CUDA tensors, got {value.device}")
    for name, t in (("sampling_locations", loc), ("attention_weights", attn)):
        if t.device != value.device:
            raise ValueError(f"{name} on {t.device}, value on {value.device}")
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"value dtype {value.dtype}: the kernel takes float32 or bfloat16")
    if loc.dtype != torch.float32:
        raise ValueError(f"sampling_locations dtype {loc.dtype}: the kernel takes float32")
    if attn.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention_weights dtype {attn.dtype}: the kernel takes "
                         "float32 or bfloat16")
    if value.dim() != 4:
        raise ValueError(f"value must be (B, S, M, D), got {tuple(value.shape)}")
    B, S, M, D = value.shape
    L = len(spatial_shapes)
    if S != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"value has {S} tokens, spatial_shapes {spatial_shapes}")
    if loc.dim() != 6 or loc.shape[0] != B or loc.shape[2] != M \
            or loc.shape[3] != L or loc.shape[5] != 2:
        raise ValueError(f"sampling_locations {tuple(loc.shape)} does not match "
                         f"value {tuple(value.shape)} and {L} levels")
    Lq, P = loc.shape[1], loc.shape[4]
    if tuple(attn.shape) != (B, Lq, M, L, P):
        raise ValueError(f"attention_weights {tuple(attn.shape)}, expected "
                         f"{(B, Lq, M, L, P)}")
    for name, t in (("value", value), ("sampling_locations", loc),
                    ("attention_weights", attn)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, S, M, D, Lq, L, P


def _launch(value, spatial_shapes, loc, attn) -> torch.Tensor:
    B, S, M, D, Lq, L, P = _check(value, spatial_shapes, loc, attn)
    lib = _build.load("ms_deform_attn_fwd")
    fn = lib.msda_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(B, Lq, M * D, dtype=value.dtype, device=value.device)
    shapes = (ctypes.c_int * (2 * L))(*[int(v) for hw in spatial_shapes for v in hw])
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = fn(value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
                 B, S, M, D, Lq, L, P, shapes,
                 int(value.dtype == torch.bfloat16), int(attn.dtype == torch.bfloat16),
                 stream)
    if err != 0:
        raise RuntimeError(f"MSDA forward kernel launch failed: CUDA error {err}")
    ms_deform_attn.launches += 1
    return out


class _MSDeformAttnKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, loc, attn, spatial_shapes):
        return _launch(value, spatial_shapes, loc, attn)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError("MSDA backward kernel (K2) not ported yet")


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """MSDA forward: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. `ms_deform_attn.launches` counts kernel launches and
    `ms_deform_attn.plain_calls` counts calls sent to the plain version."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if value.device.type == "cpu":
        ms_deform_attn.plain_calls += 1
        return ms_deform_attn_torch(value, spatial_shapes, sampling_locations,
                                    attention_weights)
    return _MSDeformAttnKernel.apply(value, sampling_locations, attention_weights,
                                     spatial_shapes)


ms_deform_attn.launches = 0
ms_deform_attn.plain_calls = 0
