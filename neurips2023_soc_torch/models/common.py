"""Shared building blocks (torch twins of neurips2023_soc_tpu/models/common.py).

Precision follows the JAX package's `dtype=` field: every parameter is
float32 and each layer casts its inputs and parameters to its compute dtype,
as flax's Dense/Conv do. Normalizations compute their statistics in float32
and return the compute dtype. Where the JAX code multiplies raw arrays of two
dtypes (`MultiheadAttention`), the port promotes the same way JAX does.

Every module that owns parameters has `init_params(generator)`; `init_weights`
runs them children-first, so a parent can override a child's default init
(the deformable attention's zero kernels and direction-grid bias).

Epsilons: flax's LayerNorm/GroupNorm default to 1e-6 where torch's default to
1e-5, so every norm here takes 1e-6 unless the JAX code sets its own.

All sequence tensors are batch-major (B, S, C); feature maps are channels-last.

Dropout sits where the JAX package has `deterministic=`. A layer's forward
takes `rng`, a torch.Generator on the tensors' device: with a generator it
draws its masks from it (training mode; the train step reseeds it every
step, the counterpart of `rngs={"dropout": rng}`), without one it applies no
dropout (inference, and every frozen or deterministic path).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

FLAX_EPS = 1e-6


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialize every parameter from `generator`, children before parents."""
    with torch.no_grad():
        for m in reversed(list(module.modules())):
            init = getattr(m, "init_params", None)
            if init is not None:
                init(generator)
    return module


def _promote(*xs: torch.Tensor):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


class Dropout(nn.Module):
    """flax nn.Dropout twin: with a generator, keep each element with
    probability 1 - p and scale it by 1 / (1 - p); without one, identity."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if rng is None or self.p == 0.0:
            return x
        if self.p >= 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))

    def extra_repr(self) -> str:
        return f"p={self.p}"


def get_activation(name: str) -> Callable:
    # flax's nn.gelu defaults to the tanh approximation
    return {"relu": F.relu, "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


class Linear(nn.Module):
    """flax nn.Dense twin: weight (out, in) float32, computed in `dtype`."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        if bias:
            self.bias = nn.Parameter(torch.empty(out_features))
        else:
            self.register_parameter("bias", None)
        self.dtype = dtype

    def init_params(self, generator):
        nn.init.normal_(self.weight, std=self.weight.shape[1] ** -0.5,
                        generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.Module):
    """Statistics in float32, output in `dtype`."""

    def __init__(self, dim: int, eps: float = FLAX_EPS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.eps = eps
        self.dtype = dtype

    def init_params(self, generator):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)
        return y.to(self.dtype)


class GroupNorm(nn.Module):
    """flax nn.GroupNorm on channels-last maps (N, ..., C): statistics per
    (sample, group) over every other axis, in float32."""

    def __init__(self, num_groups: int, channels: int, eps: float = FLAX_EPS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.eps = eps
        self.dtype = dtype

    def init_params(self, generator):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, C, G = x.shape[0], x.shape[-1], self.num_groups
        xf = x.float().reshape(N, -1, G, C // G)
        var, mean = torch.var_mean(xf, dim=(1, 3), unbiased=False, keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (y * self.weight + self.bias).to(self.dtype)


class Conv2d(nn.Module):
    """flax nn.Conv twin on channels-last maps (N, H, W, C); weight in the
    torch layout (out, in, kh, kw)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def init_params(self, generator):
        fan_in = self.weight[0].numel()
        nn.init.normal_(self.weight, std=fan_in ** -0.5, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt),
                     self.bias.to(dt), self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class Embedding(nn.Module):
    """A (num, dim) float32 table (torch key `<name>.weight`)."""

    def __init__(self, num: int, dim: int, std: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim))
        self.std = std

    def init_params(self, generator):
        nn.init.normal_(self.weight, std=self.std, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameterization (packed in_proj),
    batch-major. key_padding_mask: (B, S_k) True on padding; attn_mask:
    bool (True = blocked) or additive, (S_q, S_k) or (B*H, S_q, S_k)."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.d_model, self.num_heads, self.dtype = d_model, num_heads, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = Linear(d_model, d_model, dtype=dtype)
        self.attn_drop = Dropout(dropout)

    def init_params(self, generator):
        nn.init.xavier_uniform_(self.in_proj_weight, generator=generator)
        nn.init.zeros_(self.in_proj_bias)

    def forward(self, query, key, value, key_padding_mask=None, attn_mask=None, rng=None):
        C, H = self.d_model, self.num_heads
        Dh = C // H
        w = self.in_proj_weight.to(self.dtype)
        b = self.in_proj_bias.to(self.dtype)

        def proj(x, i):
            x, wi, bi = _promote(x, w[i * C:(i + 1) * C], b[i * C:(i + 1) * C])
            return F.linear(x, wi, bi)

        q, k, v = proj(query, 0), proj(key, 1), proj(value, 2)
        B, Sq, Sk = q.shape[0], q.shape[1], k.shape[1]
        q = q.view(B, Sq, H, Dh).transpose(1, 2)
        k = k.view(B, Sk, H, Dh).transpose(1, 2)
        v = v.view(B, Sk, H, Dh).transpose(1, 2)
        q, k = _promote(q, k)
        logits = (q @ k.transpose(-2, -1)) / math.sqrt(Dh)
        if attn_mask is not None:
            if attn_mask.dtype == torch.bool:
                logits = logits.masked_fill(attn_mask, -1e9)
            else:
                m = attn_mask
                if m.dim() == 3:  # (B*H, Sq, Sk) torch convention
                    m = m.view(B, H, Sq, Sk)
                logits = logits + m.to(logits.dtype)
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :], -1e9)
        attn = torch.softmax(logits.float(), dim=-1).to(self.dtype)
        attn = self.attn_drop(attn, rng)
        attn, v = _promote(attn, v)
        out = (attn @ v).transpose(1, 2).reshape(B, Sq, C)
        return self.out_proj(out)


class MLP(nn.Module):
    """DETR-style relu MLP."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        dims_in = [input_dim] + [hidden_dim] * (num_layers - 1)
        dims_out = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Linear(i, o, dtype=dtype) for i, o in zip(dims_in, dims_out))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class FeatureResizer(nn.Module):
    """Linear + LayerNorm(eps=1e-12) + dropout."""

    def __init__(self, input_dim: int, output_dim: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.1):
        super().__init__()
        self.fc = Linear(input_dim, output_dim, dtype=dtype)
        self.layer_norm = LayerNorm(output_dim, eps=1e-12, dtype=dtype)
        self.drop = Dropout(dropout)

    def forward(self, x, rng=None):
        return self.drop(self.layer_norm(self.fc(x)), rng)


class MMF(nn.Module):
    """Multimodal multiplicative fusion: one cross-attention, its output
    multiplied into the target."""

    def __init__(self, d_model: int, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.multihead_attn = MultiheadAttention(d_model, num_heads, dtype)

    def forward(self, tgt, memory, memory_key_padding_mask=None, pos=None,
                query_pos=None):
        q = tgt if query_pos is None else tgt + query_pos
        k = memory if pos is None else memory + pos
        tgt2 = self.multihead_attn(q, k, memory,
                                   key_padding_mask=memory_key_padding_mask)
        return tgt * tgt2


class FFNLayer(nn.Module):
    """Post-norm transformer FFN block."""

    def __init__(self, d_model: int, dim_feedforward: int = 2048,
                 activation: str = "relu", dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.linear1 = Linear(d_model, dim_feedforward, dtype=dtype)
        self.linear2 = Linear(dim_feedforward, d_model, dtype=dtype)
        self.norm = LayerNorm(d_model, dtype=dtype)
        self.activation = get_activation(activation)
        self.drop = Dropout(dropout)

    def forward(self, x, rng=None):
        h = self.drop(self.activation(self.linear1(x)), rng)
        return self.norm(x + self.drop(self.linear2(h), rng))


class SelfAttentionLayer(nn.Module):
    """Post-norm self-attention block."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, num_heads, dtype, dropout)
        self.norm = LayerNorm(d_model, dtype=dtype)
        self.drop = Dropout(dropout)

    def forward(self, tgt, tgt_mask=None, tgt_key_padding_mask=None, query_pos=None,
                rng=None):
        q = tgt if query_pos is None else tgt + query_pos
        tgt2 = self.self_attn(q, q, tgt, key_padding_mask=tgt_key_padding_mask,
                              attn_mask=tgt_mask, rng=rng)
        return self.norm(tgt + self.drop(tgt2, rng))


class CrossAttentionLayer(nn.Module):
    """Post-norm cross-attention block."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.multihead_attn = MultiheadAttention(d_model, num_heads, dtype, dropout)
        self.norm = LayerNorm(d_model, dtype=dtype)
        self.drop = Dropout(dropout)

    def forward(self, tgt, memory, memory_key_padding_mask=None, pos=None,
                query_pos=None, rng=None):
        q = tgt if query_pos is None else tgt + query_pos
        k = memory if pos is None else memory + pos
        tgt2 = self.multihead_attn(q, k, memory,
                                   key_padding_mask=memory_key_padding_mask, rng=rng)
        return self.norm(tgt + self.drop(tgt2, rng))
