"""Multi-scale deformable attention (MSDA): the plain PyTorch versions of the
forward and backward and the wrappers of their hand-written CUDA kernels
(`csrc/ms_deform_attn_fwd.cu`, `csrc/ms_deform_attn_bwd.cu`).

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
tensor to the forward kernel; it never falls back from one to the other. Its
gradient is the backward kernel for a CUDA tensor and autograd through
`ms_deform_attn_torch` for a CPU tensor (as `ms_deform_attn_torch_bwd`
computes it): (d_value, d_sampling_locations, d_attention_weights), each in
its input's dtype, with d_value summed in float32 and rounded once.

Kernel routes, chosen from the shape alone (`fwd_route`, `bwd_route`): "vec"
where D is a power-of-two multiple of 8 up to 256 (D / 8 threads of 8 channels
per (b, q, m), each sample's geometry computed once; K2 merges a CTA's hits on
one corner in shared memory before a 16-byte vector reduction of d_value; D up
to 256 for K1, 128 for K2), else "scalar" (K1: one thread per output element;
K2: one warp per (b, q, m)). A route the shape does not fit is refused, never
replaced by another.

Rounding: the JAX XLA path rounds each bf16 `value * weight` product to bf16
before its float32 sum (neurips2023_soc_tpu/ops/ms_deform_attn.py:202-204);
the kernel and the plain version here keep the product in float32. So on the
card the kernel is held against the plain version, not against JAX.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import torch

from . import _build

SpatialShapes = Tuple[Tuple[int, int], ...]
MAX_LEVELS = 16  # csrc/msda_common.cuh:MSDA_MAX_LEVELS


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


def ms_deform_attn_torch_bwd(
    value: torch.Tensor,
    spatial_shapes: SpatialShapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    grad_out: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward: autograd through `ms_deform_attn_torch` (which
    recomputes the forward). Every corner outside its level has zero weight and
    zero slope; `d_loc_x = W * dL/dx` for the pixel coordinate
    `x = loc_x * W - 0.5` (neurips2023_soc_tpu/ops/ms_deform_attn.py:100-113)."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in
                  (value, sampling_locations, attention_weights)]
        out = ms_deform_attn_torch(inputs[0], spatial_shapes, inputs[1], inputs[2])
        return torch.autograd.grad(out, inputs, grad_out)


# ---------------------------------------------------------------- kernel routes
# Shapes, not failures, choose a kernel's route: the C side refuses a route the shape
# does not fit, and the wrapper raises.
VEC_THREADS = 256  # threads per CTA of K1's vec route
# K2's room for dynamic shared memory on the H100 (and H200): the 232,448 bytes a CTA may
# opt into less the vec kernel's 16 static bytes. The route rule's limit where no card is
# named; on a card, the rule takes that card's own room (card_smem_room).
SMEM_LIMIT = 232_432


def _pow2(n: int) -> bool:
    return n >= 1 and n & (n - 1) == 0


def _vec_shape(D: int, P: int, kernel: str, smem_limit: int = SMEM_LIMIT) -> bool:
    """D / 8 threads of 8 channels each per (b, q, m), D / 8 a power of two (so a group
    never straddles a warp) up to 32 for K1 and 16 for K2, and the shared memory the
    kernel stages within its limit: K1 32 bytes per sample of its 256 threads' groups
    under 48 KB; K2 (csrc/ms_deform_attn_bwd.cu:vec_plan) 64 groups' samples (32 bytes
    each), a hash table of twice the level's 64 * P * 4 hits (8 bytes a slot), 12 bytes
    per hit and the 64 cotangent slices, within `smem_limit`."""
    t8 = D // 8
    if D % 8 or not _pow2(t8) or P < 1:
        return False
    if kernel == "fwd":
        return t8 <= 32 and VEC_THREADS // t8 * P * 32 <= 48 * 1024
    hits = 64 * P * 4
    slots = 1 << max(4, (2 * hits - 1).bit_length())
    return t8 <= 16 and 64 * P * 32 + 8 * slots + 12 * hits + 64 * D * 4 <= smem_limit


def fwd_route(D: int, P: int) -> str:
    """K1's route for a head width D and P points: "vec" (8-channel slices, each
    sample's geometry computed once per (b, q, m)) or "scalar" (one thread per
    output element)."""
    return "vec" if _vec_shape(D, P, "fwd") else "scalar"


def bwd_route(D: int, P: int, device=None) -> str:
    """K2's route for a head width D and P points: "vec" (8-channel slices, a CTA's
    hits on one corner merged in shared memory before a 16-byte vector reduction of
    d_value) or "scalar" (one warp per (b, q, m)). On a CUDA `device` the shared
    memory rule takes that card's room for dynamic shared memory, as the C side does;
    otherwise the H100's."""
    limit = SMEM_LIMIT
    if device is not None and torch.device(device).type == "cuda":
        limit = card_smem_room(torch.device(device))
    return "vec" if _vec_shape(D, P, "bwd", limit) else "scalar"


ROUTES = {"vec": 0, "scalar": 1}  # the C side's route numbers
_fns: Dict[str, object] = {}
_optin: Dict[int, int] = {}


def card_smem_room(device: torch.device) -> int:
    """The dynamic shared memory a K2 vec-route CTA may opt into on a CUDA card (the
    card's opt-in limit less the kernel's static shared memory), as K2's library found
    it (csrc/ms_deform_attn_bwd.cu:msda_bwd_smem_room), kept per card."""
    index = torch.cuda.current_device() if device.index is None else device.index
    limit = _optin.get(index)
    if limit is None:
        fn = _build.load("ms_deform_attn_bwd").msda_bwd_smem_room
        fn.argtypes, fn.restype = [], ctypes.c_int
        with torch.cuda.device(index):
            limit = fn()
        if limit < 0:
            raise RuntimeError(f"K2 could not read card {index}'s shared memory limit: CUDA "
                               f"error {-limit}")
        _optin[index] = limit
    return limit


def _kernel_fn(name: str):
    """The C entry point msda_<name> of one kernel library, its ctypes signature set
    once: the tensor pointers (4 forward, 7 backward), B, S, M, D, Lq, L, P, the
    (H, W) pairs, the two dtype flags, the route and the stream."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(f"ms_deform_attn_{name}"), f"msda_{name}")
        fn.argtypes = [ctypes.c_void_p] * (4 if name == "fwd" else 7) + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


@functools.lru_cache(maxsize=64)
def _shapes_array(spatial_shapes: SpatialShapes):
    return (ctypes.c_int * (2 * len(spatial_shapes)))(
        *[v for hw in spatial_shapes for v in hw])


def _aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """t itself when its data is `nbytes`-aligned, else an aligned copy (the vector
    routes load 8 or 16 bytes at a time)."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


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
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"{L} levels: the kernel takes 1 to {MAX_LEVELS}")
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
    """K1 on CUDA tensors, by the route the shape takes."""
    B, S, M, D, Lq, L, P = _check(value, spatial_shapes, loc, attn)
    route = fwd_route(D, P)
    if route == "vec":
        value, loc = _aligned(value, 16), _aligned(loc, 8)
    fn = _kernel_fn("fwd")
    out = torch.empty(B, Lq, M * D, dtype=value.dtype, device=value.device)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = fn(value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
                 B, S, M, D, Lq, L, P, _shapes_array(spatial_shapes),
                 int(value.dtype == torch.bfloat16), int(attn.dtype == torch.bfloat16),
                 ROUTES[route], stream)
    if err != 0:
        raise RuntimeError(f"MSDA forward kernel ({route} route) launch failed: CUDA error "
                           f"{err}")
    ms_deform_attn.launches += 1
    return out


def _launch_bwd(value, spatial_shapes, loc, attn, grad_out):
    """K2 on CUDA tensors, by the route the shape takes."""
    B, S, M, D, Lq, L, P = _check(value, spatial_shapes, loc, attn)
    g = grad_out.contiguous()
    if tuple(g.shape) != (B, Lq, M * D) or g.dtype != value.dtype \
            or g.device != value.device:
        raise ValueError(f"grad_out {tuple(g.shape)} {g.dtype} on {g.device}, expected "
                         f"{(B, Lq, M * D)} {value.dtype} on {value.device}")
    route = bwd_route(D, P, value.device)
    if route == "vec":
        value, loc, g = _aligned(value, 16), _aligned(loc, 8), _aligned(g, 16)
    fn = _kernel_fn("bwd")
    # f32 sums (atomics), cast once at the end
    d_value = torch.zeros(B, S, M, D, dtype=torch.float32, device=value.device)
    d_loc = torch.empty_like(loc)
    d_attn = torch.empty_like(attn)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = fn(value.data_ptr(), loc.data_ptr(), attn.data_ptr(), g.data_ptr(),
                 d_value.data_ptr(), d_loc.data_ptr(), d_attn.data_ptr(),
                 B, S, M, D, Lq, L, P, _shapes_array(spatial_shapes),
                 int(value.dtype == torch.bfloat16), int(attn.dtype == torch.bfloat16),
                 ROUTES[route], stream)
    if err != 0:
        raise RuntimeError(f"MSDA backward kernel ({route} route) launch failed: CUDA error "
                           f"{err}")
    ms_deform_attn.bwd_launches += 1
    return d_value.to(value.dtype), d_loc, d_attn


class _MSDeformAttnKernel(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernel."""

    @staticmethod
    def forward(ctx, value, loc, attn, spatial_shapes):
        ctx.save_for_backward(value, loc, attn)
        ctx.spatial_shapes = spatial_shapes
        return _launch(value, spatial_shapes, loc, attn)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        grads = _launch_bwd(value, ctx.spatial_shapes, loc, attn, grad_out)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None)


def _count_plain_bwd(grad):
    ms_deform_attn.plain_bwd_calls += 1


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """MSDA forward: the CUDA kernels for CUDA tensors, the plain versions for
    CPU tensors. Counters: `ms_deform_attn.launches` / `.bwd_launches` count
    forward / backward kernel launches, `.plain_calls` / `.plain_bwd_calls`
    the forward / backward calls sent to the plain versions."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if value.device.type == "cpu":  # autograd differentiates the plain version
        ms_deform_attn.plain_calls += 1
        out = ms_deform_attn_torch(value, spatial_shapes, sampling_locations,
                                   attention_weights)
        if out.requires_grad:
            out.register_hook(_count_plain_bwd)
        return out
    return _MSDeformAttnKernel.apply(value, sampling_locations, attention_weights,
                                     spatial_shapes)


ms_deform_attn.launches = 0
ms_deform_attn.plain_calls = 0
ms_deform_attn.bwd_launches = 0
ms_deform_attn.plain_bwd_calls = 0
