"""ResNet-50 backbone with frozen BatchNorm (torch twin of
neurips2023_soc_tpu/models/resnet.py; reference models/backbone.py:20-101).

FrozenBN applies y = x * w + b with w = weight / sqrt(running_var + eps) and
b = bias - running_mean * weight / sqrt(running_var + eps), computed in
float32 and cast to the compute dtype. Its four tensors are parameters, as
in the JAX module, not buffers as in the reference: their gradients enter
the optimizer's clip norm (optax.clip_by_global_norm runs before the frozen
mask) and training/optim.py labels them `frozen`, so they are never updated.
The JAX package also trains `conv1` and `layer1`, which the reference froze;
the port keeps that.

Layout: a 7x7/2 stem, a 3x3/2 max pool with padding 1, then four stages of
bottlenecks (ResNet v1.5: the stride on the 3x3 conv) with 256, 512, 1024
and 2048 output channels at strides 4, 8, 16 and 32. Convolutions run in
cuDNN on channels-last memory. Keys are torchvision's under
`backbone.0.body.` (the reference's IntermediateLayerGetter): `conv1`,
`bn1`, `layer{s}.{i}.conv{1,2,3}`, `bn{1,2,3}`, `downsample.0` / `.1`, each
FrozenBN with `weight`, `bias`, `running_mean`, `running_var`, so a
reference checkpoint loads.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class FrozenBN(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.running_mean = nn.Parameter(torch.zeros(features))
        self.running_var = nn.Parameter(torch.ones(features))
        self.eps, self.dtype = eps, dtype

    def init_params(self, generator):
        for p, v in ((self.weight, 1.0), (self.bias, 0.0), (self.running_mean, 0.0),
                     (self.running_var, 1.0)):
            nn.init.constant_(p, v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, C, H, W)."""
        root = torch.sqrt(self.running_var + self.eps)
        w = (self.weight / root).to(self.dtype)
        b = (self.bias - self.running_mean * self.weight / root).to(self.dtype)
        return x * w[:, None, None] + b[:, None, None]


class Conv(nn.Module):
    """A bias-free convolution on (N, C, H, W) tensors (torch's weight
    layout (out, in, kh, kw)), computed in `dtype`."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def init_params(self, generator):
        nn.init.normal_(self.weight, std=self.weight[0].numel() ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(self.dtype), None, self.stride, self.padding)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1, downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = features * 4
        self.conv1 = Conv(in_ch, features, 1, dtype=dtype)
        self.bn1 = FrozenBN(features, dtype=dtype)
        self.conv2 = Conv(features, features, 3, stride, 1, dtype=dtype)
        self.bn2 = FrozenBN(features, dtype=dtype)
        self.conv3 = Conv(features, out, 1, dtype=dtype)
        self.bn3 = FrozenBN(out, dtype=dtype)
        self.downsample = nn.Sequential(Conv(in_ch, out, 1, stride, dtype=dtype),
                                        FrozenBN(out, dtype=dtype)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet50Backbone(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32,
                 layer_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(3, 64, 7, 2, 3, dtype=dtype)
        self.bn1 = FrozenBN(64, dtype=dtype)
        in_ch, features = 64, 64
        for stage, blocks in enumerate(layer_sizes):
            stride = 1 if stage == 0 else 2
            layer = []
            for i in range(blocks):
                layer.append(Bottleneck(in_ch, features, stride if i == 0 else 1,
                                        downsample=(i == 0), dtype=dtype))
                in_ch = features * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layer))
            features *= 2
        self.num_stages = len(layer_sizes)

    def forward(self, video: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """video: (B, T, H, W, 3) -> 4 per-frame maps (B*T, Hi, Wi, Ci),
        b-major. `rng` is unused (no drop path); it keeps the backbones'
        signature."""
        B, T, H, W, _ = video.shape
        # an NCHW view of channels-last memory: cuDNN keeps that layout
        x = video.reshape(B * T, H, W, 3).to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
            outs.append(x.permute(0, 2, 3, 1))
        return outs
