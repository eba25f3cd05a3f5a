"""(Shifted-)window attention for Video-Swin: the two plain PyTorch versions
and the wrapper of the hand-written CUDA kernel K3
(`csrc/window_attention_fwd.cu`).

`window_attention_torch` is what the JAX package computes by default (XLA,
neurips2023_soc_tpu/ops/window_attention.py:window_attention_xla): q scaled
and logits formed in the compute dtype, the relative-position bias and the
materialized (nW, N, N) shift mask added in the compute dtype, a float32
softmax, and the product with v in the compute dtype. The backbone runs it
with `swin_attn_impl: xla`, every config's default.

`window_attention_ref` has the semantics of the TPU kernel
(`window_attention_pallas`, its `_attend_one`), step for step: q.k in
float32, times Dh^-1/2, plus the float32 bias, minus 100 where the region ids
of the two tokens differ (the mask is built from the compact (nW, N) ids),
a float32 softmax, p rounded to v's dtype, p.v summed in float32 and rounded
once to q's dtype. In float32 the two versions agree to rounding; in bf16
they differ by the places they round.

`window_attention` is what `swin_attn_impl: pallas` runs: K3 for CUDA
tensors, `window_attention_ref` for CPU tensors, never one in place of the
other. K3 has two routes, picked by q's dtype. bfloat16 runs on the tensor
cores (`mma.sync`, f32 accumulators, an online softmax in f32): it rounds the
unnormalised exp2(s - max) to bf16 for the product with v and divides by the
f32 row sum once at the end, where the TPU kernel rounds the normalised p.
float32 runs on the CUDA cores and keeps p in float32. So on the card either
route is held against `window_attention_ref` run in float32 on the same
inputs. It has no backward (the JAX file defines none): on a CUDA tensor
that requires a gradient it raises, and training keeps `swin_attn_impl: xla`.

Counters: `window_attention.launches` (kernel launches),
`window_attention.plain_calls` (calls sent to `window_attention_ref`) and
`window_attention_torch.calls`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

HEAD_DIM = 32  # the kernel's Dh: every SWIN_CONFIGS entry has 32 channels per head
MAX_TOKENS = 512  # tokens per window the kernel takes (392 at window (8, 7, 7))


def mask_from_ids(ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(nW, N) int region labels -> (nW, N, N) additive 0 / -100 mask."""
    neq = ids[:, None, :] != ids[:, :, None]
    return torch.where(neq, -100.0, 0.0).to(dtype)


def window_attention_torch(
    q: torch.Tensor,  # (B_, H, N, Dh)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,  # (H, N, N)
    mask: Optional[torch.Tensor] = None,  # (nW, N, N) additive; B_ % nW == 0
) -> torch.Tensor:
    window_attention_torch.calls += 1
    B_, H, N, Dh = q.shape
    attn = (q * Dh ** -0.5) @ k.transpose(-2, -1)
    attn = attn + bias[None].to(attn.dtype)
    if mask is not None:
        nW = mask.shape[0]
        attn = attn.view(B_ // nW, nW, H, N, N) + mask[None, :, None].to(attn.dtype)
        attn = attn.view(B_, H, N, N)
    attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
    return attn @ v


window_attention_torch.calls = 0


def window_attention_ref(
    q: torch.Tensor,  # (B_, H, N, Dh)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,  # (H, N, N)
    ids: Optional[torch.Tensor] = None,  # (nW, N) int region labels; B_ % nW == 0
) -> torch.Tensor:
    """The TPU kernel's semantics (neurips2023_soc_tpu/ops/window_attention.py
    :_attend_one, :74-89) in plain PyTorch."""
    B_, H, N, Dh = q.shape
    s = (q.float() @ k.float().transpose(-2, -1)) * Dh ** -0.5
    s = s + bias.float()[None]
    if ids is not None:
        nW = ids.shape[0]
        s = (s.view(B_ // nW, nW, H, N, N) + mask_from_ids(ids)[None, :, None]).view(
            B_, H, N, N)
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(-1, keepdim=True)
    return (p.to(v.dtype).float() @ v.float()).to(q.dtype)


def _check(q, k, v, bias, ids):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        raise RuntimeError(
            "the window attention kernel has no backward (the TPU kernel defines none); "
            "train with swin_attn_impl: xla")
    if q.device.type != "cuda":
        raise ValueError(f"the window attention kernel takes CUDA tensors, got {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B_, H, N, Dh), got {tuple(q.shape)}")
    B_, H, N, Dh = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on {t.device}, q "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype {q.dtype}: the kernel takes float32 or bfloat16")
    if Dh != HEAD_DIM:
        raise ValueError(f"head dim {Dh}: the kernel takes {HEAD_DIM}")
    if not 1 <= N <= MAX_TOKENS:
        raise ValueError(f"{N} tokens per window: the kernel takes 1 to {MAX_TOKENS}")
    if tuple(bias.shape) != (H, N, N) or bias.device != q.device:
        raise ValueError(f"bias {tuple(bias.shape)} on {bias.device}, expected {(H, N, N)} "
                         f"on {q.device}")
    if ids is not None:
        if ids.dim() != 2 or ids.shape[1] != N or B_ % ids.shape[0] or ids.device != q.device:
            raise ValueError(f"ids {tuple(ids.shape)} on {ids.device}: expected (nW, {N}) "
                             f"with {B_} % nW == 0, on {q.device}")
    return B_, H, N, Dh


def _kernel_layout(q, k, v):
    """q, k, v with shared strides over (window, head, token), a contiguous
    head dim and 16-byte aligned rows: the views of one fused qkv buffer are
    taken as they are, anything else is made contiguous."""
    def fits(t):
        el = t.element_size()
        return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
                and all(s * el % 16 == 0 for s in t.stride()[:3]))

    if q.stride() == k.stride() == v.stride() and all(fits(t) for t in (q, k, v)):
        return q, k, v
    return q.contiguous(), k.contiguous(), v.contiguous()


def _launch(q, k, v, bias, ids) -> torch.Tensor:
    B_, H, N, Dh = _check(q, k, v, bias, ids)
    q, k, v = _kernel_layout(q, k, v)
    bias = bias.to(torch.float32).contiguous()
    if bias.data_ptr() % 16:  # the kernel copies bias rows in 16-byte pieces
        bias = bias.clone()
    ids_arg, nW = None, 1
    if ids is not None:
        ids = ids.to(torch.int32).contiguous()
        ids_arg, nW = ids.data_ptr(), ids.shape[0]
    fn = _build.load("window_attention_fwd").wattn_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(B_, N, H, Dh, dtype=q.dtype, device=q.device)
    sb, sh, sn, _ = q.stride()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), ids_arg,
                 out.data_ptr(), B_, H, N, Dh, nW, sb, sh, sn,
                 int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"window attention kernel launch failed: CUDA error {err}")
    window_attention.launches += 1
    return out.permute(0, 2, 1, 3)  # (B_, H, N, Dh) view of (B_, N, H, Dh) memory


def window_attention(
    q: torch.Tensor,  # (B_, H, N, Dh)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,  # (H, N, N)
    ids: Optional[torch.Tensor] = None,  # (nW, N) int region labels; B_ % nW == 0
) -> torch.Tensor:
    """K3 for CUDA tensors, `window_attention_ref` for CPU tensors. Returns
    (B_, H, N, Dh); the kernel's result is a view whose memory is
    (B_, N, H, Dh), so `.transpose(1, 2).reshape(B_, N, H * Dh)` copies
    nothing."""
    if q.device.type == "cpu":
        window_attention.plain_calls += 1
        return window_attention_ref(q, k, v, bias, ids)
    return _launch(q, k, v, bias, ids)


window_attention.launches = 0
window_attention.plain_calls = 0
