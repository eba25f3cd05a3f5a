"""LayerNorm over the last axis: the plain PyTorch version and the wrapper of
the hand-written CUDA kernel (`csrc/layer_norm_fwd.cu`).

`layer_norm_ref` is what `models.common.LayerNorm` computes everywhere the
kernel does not run: statistics and affine map in float32 (PyTorch's
`F.layer_norm` on the upcast input, float32 weight and bias), one rounding to
the module's dtype. In a bfloat16 model on the card that is three kernels: the
copy to float32, the float32 norm and the copy back.

`layer_norm` launches the kernel when the input lies on a CUDA card, the
output is bfloat16 and no gradient is needed; every other call takes
`layer_norm_ref`: CPU tensors, float32 modules, and a forward that needs a
gradient through the norm (the kernel has no backward). The route asks only
whether a gradient is needed, so in bfloat16 (AMP) training the trainable
modules' norms take the plain path and a frozen module run under
`torch.no_grad()`, as the text encoder is, takes the kernel. The kernel reads
x (bfloat16 or float32) once, keeps the row in registers for the float32 mean
and centred second moment, and writes the bfloat16 result once.
It differs from `layer_norm_ref` on the card only by the order of its float32
sums, which moves a rounding to bfloat16 by at most one ulp on a few elements.

`compare_to_ref` holds a kernel result against `layer_norm_ref`; the card
tests and `chip_smoke.py` use it.

Counters: `layer_norm.launches` (kernel launches), `layer_norm.plain_calls`
(calls sent to `layer_norm_ref`).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build


def layer_norm_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                   dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm over the last axis in float32, rounded once to `dtype`."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight, bias, eps).to(dtype)


# the share of elements in which the kernel may differ from layer_norm_ref at all
MAX_DIFFER_SHARE = 1e-3


def bf16_ulp(y: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each |y| (7 stored mantissa bits), in float32."""
    e = torch.floor(torch.log2(y.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def compare_to_ref(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """How far the kernel's bfloat16 `got` lies from layer_norm_ref's `want`
    (same shape): (share of elements that differ, largest difference over its
    bound, that element's flat index). The bound is one bf16 ulp of `want`
    plus float32 rounding of the row's statistics, 2**-18 of the row's largest
    |want| (where t w and b nearly cancel, two float32 sums in another order
    differ by many ulps of the tiny result). A NaN or infinity that `want`
    lacks reads as beyond the bound. The kernel passes where the share is at
    most MAX_DIFFER_SHARE and the ratio at most 1."""
    got, want = got.float(), want.float()
    bound = bf16_ulp(want) + 2.0 ** -18 * want.abs().amax(-1, keepdim=True)
    ratio = ((got - want).abs() / bound).nan_to_num(nan=float("inf"))
    ratio = torch.where(got == want, torch.zeros_like(ratio), ratio)
    i = int(ratio.argmax())
    return (got != want).float().mean().item(), ratio.flatten()[i].item(), i


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point ln_fwd, its ctypes signature set once: x, w, b, y, rows,
    C, eps, whether x is bfloat16, the card's index and the stream."""
    fn = _build.load("layer_norm_fwd").ln_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    """The kernel on a CUDA tensor: bfloat16 (..., C) out."""
    if x.dtype is not torch.bfloat16 and x.dtype is not torch.float32:
        raise ValueError(f"dtype {x.dtype}: the LayerNorm kernel takes bfloat16 or float32")
    C, dev = x.shape[-1], x.get_device()
    for name, t in (("weight", weight), ("bias", bias)):
        if t.dtype is not torch.float32 or t.get_device() != dev or t.numel() != C \
                or not t.is_contiguous():
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on {t.device}: the LayerNorm "
                             f"kernel takes contiguous float32 ({C},) on {x.device}")
    if not x.is_contiguous():
        x = x.contiguous()
    y = torch.empty_like(x, dtype=torch.bfloat16)
    # the raw handle of PyTorch's current stream on the card (no Stream object is made)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    err = _kernel()(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                    x.numel() // C, C, eps, x.dtype is torch.bfloat16, dev, stream)
    if err != 0:
        raise RuntimeError(f"LayerNorm kernel launch failed: CUDA error {err}")
    layer_norm.launches += 1
    return y


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
               dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm over the last axis of x with float32 `weight` and `bias`, in
    `dtype`: the kernel for a CUDA input, bfloat16 out and no gradient, else
    `layer_norm_ref`."""
    if x.is_cuda and dtype is torch.bfloat16 and not (torch.is_grad_enabled() and (
            x.requires_grad or weight.requires_grad or bias.requires_grad)):
        return _launch(x, weight, bias, eps)
    layer_norm.plain_calls += 1
    return layer_norm_ref(x, weight, bias, eps, dtype)


layer_norm.launches = 0
layer_norm.plain_calls = 0
