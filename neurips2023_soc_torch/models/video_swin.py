"""Video Swin Transformer backbone (torch twin of
neurips2023_soc_tpu/models/video_swin.py).

Patch size (1, 4, 4), window (8, 7, 7) 3D shifted windows, 4 stages with
PatchMerging applied after each stage's output is collected, so all four
stride-4/8/16/32 maps are emitted per frame. The relative-position bias is a
plain index gather into the table; the shift mask (additive -100 between
regions) is derived on the device from small region-id tables that are made
once per geometry. Window attention is `ops.window_attention_torch`.

Layout: channels-last. Input (B, T, H, W, 3); outputs four per-frame maps
[(B*T, H/4, W/4, C), ..., (B*T, H/32, W/32, 8C)].

Training adds stochastic depth (drop path): block i of n drops each residual
branch per sample with rate linspace(0, drop_path_rate, n)[i], keeping it
scaled by 1 / (1 - rate). The keep masks are drawn by the backbone from the
caller's generator before each block runs, so a block recomputed under
torch.utils.checkpoint sees the same masks.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops.window_attention import mask_from_ids, window_attention_torch
from .common import LayerNorm, Linear

Window = Tuple[int, int, int]


@functools.lru_cache(maxsize=64)
def _np_window_region_ids(Dp: int, Hp: int, Wp: int, window: Window,
                          shift: Window) -> np.ndarray:
    """(nW, N) int32 region ids per shifted-window token (reference
    models/video_swin_transformer.py:316-329's `img` labels)."""
    img = np.zeros((Dp, Hp, Wp), np.int32)
    cnt = 0
    for d in (slice(-window[0]), slice(-window[0], -shift[0]), slice(-shift[0], None)):
        for h in (slice(-window[1]), slice(-window[1], -shift[1]), slice(-shift[1], None)):
            for w in (slice(-window[2]), slice(-window[2], -shift[2]), slice(-shift[2], None)):
                img[d, h, w] = cnt
                cnt += 1
    wd, wh, ww = window
    win = img.reshape(Dp // wd, wd, Hp // wh, wh, Wp // ww, ww)
    return np.ascontiguousarray(win.transpose(0, 2, 4, 1, 3, 5).reshape(-1, wd * wh * ww))


@functools.lru_cache(maxsize=64)
def _region_ids(Dp: int, Hp: int, Wp: int, window: Window, shift: Window,
                device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_np_window_region_ids(Dp, Hp, Wp, window, shift)).to(device)


def _attn_mask(Dp: int, Hp: int, Wp: int, window: Window, shift: Window,
               device, dtype=torch.float32) -> torch.Tensor:
    """(nW, N, N) additive mask (0 / -100)."""
    return mask_from_ids(_region_ids(Dp, Hp, Wp, window, shift, torch.device(device)),
                         dtype)


@functools.lru_cache(maxsize=64)
def _np_rel_pos_index(window: Window) -> np.ndarray:
    """(N, N) index into the relative position bias table."""
    wd, wh, ww = window
    coords = np.stack(
        np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww), indexing="ij")
    ).reshape(3, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=64)
def _rel_pos_index(window: Window, N: int, device: torch.device) -> torch.Tensor:
    """Flat (N*N,) table rows; a clamped window uses the full window's index
    [:N, :N], as the reference does."""
    idx = _np_rel_pos_index(window)[:N, :N]
    return torch.from_numpy(np.ascontiguousarray(idx).reshape(-1)).to(device)


def _effective_window(size: Tuple[int, int, int], window: Window, shift: Window):
    """Clamp window to the input size; zero the shift where clamped
    (reference models/video_swin_transformer.py:71-84)."""
    win, sh = list(window), list(shift)
    for i in range(3):
        if size[i] <= window[i]:
            win[i] = size[i]
            sh[i] = 0
    return tuple(win), tuple(sh)


class WindowAttention3D(nn.Module):
    def __init__(self, dim: int, window: Window, num_heads: int, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window, self.num_heads, self.dtype = tuple(window), num_heads, dtype
        table_len = ((2 * window[0] - 1) * (2 * window[1] - 1) * (2 * window[2] - 1))
        self.relative_position_bias_table = nn.Parameter(torch.empty(table_len, num_heads))
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def init_params(self, generator):
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02,
                              a=-0.04, b=0.04, generator=generator)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """x: (B_, N, C) windows; mask: (nW, N, N) additive or None."""
        B_, N, C = x.shape
        H = self.num_heads
        qkv = self.qkv(x).view(B_, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B_, H, N, Dh)
        idx = _rel_pos_index(self.window, N, x.device)
        bias = self.relative_position_bias_table[idx].view(N, N, H).permute(2, 0, 1)
        out = window_attention_torch(q, k, v, bias, mask).to(self.dtype)
        return self.proj(out.transpose(1, 2).reshape(B_, N, C))


def drop_path(x: torch.Tensor, keep_mask: Optional[torch.Tensor],
              rate: float) -> torch.Tensor:
    """Per-sample stochastic depth (JAX video_swin.py:248-253): samples with
    keep_mask False are zeroed, the others scaled by 1 / (1 - rate).
    keep_mask None means identity (inference, or rate 0)."""
    if keep_mask is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    m = keep_mask.view((-1,) + (1,) * (x.dim() - 1))
    return torch.where(m, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))  # exact GELU, as the JAX swin


class SwinBlock3D(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: Window, shift: Window,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32, drop_path: float = 0.0):
        super().__init__()
        self.window, self.shift = tuple(window), tuple(shift)
        self.drop_path = float(drop_path)
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = WindowAttention3D(dim, window, num_heads, qkv_bias, dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, D, H, W, C); keep: (2, B) bool drop-path masks of the two
        residual branches, or None."""
        B, D, H, W, C = x.shape
        window, shift = _effective_window((D, H, W), self.window, self.shift)
        shortcut = x
        x = self.norm1(x)
        pad_d, pad_h, pad_w = (-D) % window[0], (-H) % window[1], (-W) % window[2]
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h, 0, pad_d))
        Dp, Hp, Wp = D + pad_d, H + pad_h, W + pad_w
        shifted = any(s > 0 for s in shift)
        mask = None
        if shifted:
            x = torch.roll(x, (-shift[0], -shift[1], -shift[2]), dims=(1, 2, 3))
            mask = _attn_mask(Dp, Hp, Wp, window, shift, x.device, x.dtype)

        wd, wh, ww = window
        nwd, nwh, nww = Dp // wd, Hp // wh, Wp // ww
        xw = x.view(B, nwd, wd, nwh, wh, nww, ww, C)
        xw = xw.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww, C)
        xw = self.attn(xw, mask)
        x = xw.view(B, nwd, nwh, nww, wd, wh, ww, C)
        x = x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, Dp, Hp, Wp, C)
        if shifted:
            x = torch.roll(x, shift, dims=(1, 2, 3))
        k_attn, k_mlp = (None, None) if keep is None else keep
        x = shortcut + drop_path(x[:, :D, :H, :W], k_attn, self.drop_path)
        return x + drop_path(self.mlp(self.norm2(x)), k_mlp, self.drop_path)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = LayerNorm(4 * dim, dtype=dtype)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, D, H, W, C) -> (B, D, H/2, W/2, 2C)."""
        H, W = x.shape[2], x.shape[3]
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class _PatchEmbed3D(nn.Module):
    def __init__(self, patch_size: Window, embed_dim: int, patch_norm: bool, dtype):
        super().__init__()
        self.patch_size, self.dtype = tuple(patch_size), dtype
        self.proj = nn.Conv3d(3, embed_dim, self.patch_size, self.patch_size)
        self.norm = LayerNorm(embed_dim, dtype=dtype) if patch_norm else None

    def init_params(self, generator):
        fan_in = self.proj.weight[0].numel()
        nn.init.normal_(self.proj.weight, std=fan_in ** -0.5, generator=generator)
        nn.init.zeros_(self.proj.bias)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        """video (B, T, H, W, 3), padded to the patch grid -> (B, T', H', W', C)."""
        dt = self.dtype
        x = F.conv3d(video.permute(0, 4, 1, 2, 3).to(dt), self.proj.weight.to(dt),
                     self.proj.bias.to(dt), stride=self.patch_size)
        x = x.permute(0, 2, 3, 4, 1)
        return self.norm(x) if self.norm is not None else x


class _Stage(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class VideoSwinBackbone(nn.Module):
    """4-stage Video Swin emitting all four per-frame feature levels. Keys
    follow the reference's `backbone.0.body` module (`patch_embed`,
    `layers.{s}.blocks.{i}`, `downsamples.{s}`, and `norm{s}` for the 2D
    Swin configs' per-stage output norms)."""

    def __init__(self, patch_size: Window = (1, 4, 4), embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: Window = (8, 7, 7),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, patch_norm: bool = True,
                 out_norms: bool = False, use_remat: bool = False,
                 dtype: torch.dtype = torch.float32, drop_path_rate: float = 0.2):
        super().__init__()
        self.patch_size, self.use_remat = tuple(patch_size), use_remat
        self.patch_embed = _PatchEmbed3D(patch_size, embed_dim, patch_norm, dtype)
        shift = tuple(w // 2 for w in window)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        stages, downs, dim = [], [], embed_dim
        for s, depth in enumerate(depths):
            first = sum(depths[:s])
            stages.append(_Stage(
                SwinBlock3D(dim, num_heads[s], window,
                            (0, 0, 0) if i % 2 == 0 else shift, mlp_ratio, qkv_bias,
                            dtype, float(dpr[first + i]))
                for i in range(depth)))
            if s < len(depths) - 1:
                downs.append(PatchMerging(dim, dtype))
                dim *= 2
        self.layers = nn.ModuleList(stages)
        self.downsamples = nn.ModuleList(downs)
        self.num_out_norms = len(depths) if out_norms else 0
        for s in range(self.num_out_norms):
            self.add_module(f"norm{s}", LayerNorm(embed_dim * 2 ** s, dtype=dtype))

    def forward(self, video: torch.Tensor, rng: Optional[torch.Generator] = None):
        """video: (B, T, H, W, 3) -> list of 4 maps (B*T, Hi, Wi, Ci). With a
        generator `rng`, drop path is applied (training)."""
        B, T, H, W, _ = video.shape
        pd, ph, pw = self.patch_size
        video = F.pad(video, (0, 0, 0, (-W) % pw, 0, (-H) % ph, 0, (-T) % pd))
        x = self.patch_embed(video)
        outs = []
        for s, stage in enumerate(self.layers):
            for block in stage.blocks:
                keep = None
                if rng is not None and block.drop_path > 0.0:
                    keep = torch.rand(2, B, generator=rng, device=x.device) \
                        < 1.0 - block.drop_path
                if self.use_remat and torch.is_grad_enabled():
                    x = torch.utils.checkpoint.checkpoint(block, x, keep,
                                                          use_reentrant=False)
                else:
                    x = block(x, keep)
            y = getattr(self, f"norm{s}")(x) if self.num_out_norms else x
            Bc, Tc, Hc, Wc, Cc = y.shape
            outs.append(y.reshape(Bc * Tc, Hc, Wc, Cc))
            if s < len(self.downsamples):
                x = self.downsamples[s](x)
        return outs


SWIN_CONFIGS = {
    "video-swin-t": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "video-swin-s": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "video-swin-b": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    # 2D image Swin: temporal window 1 and per-stage output LayerNorms
    "swin-t": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                   window=(1, 7, 7), out_norms=True, drop_path_rate=0.2),
    "swin-s": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24),
                   window=(1, 7, 7), out_norms=True, drop_path_rate=0.2),
    "swin-b": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
                   window=(1, 7, 7), out_norms=True, drop_path_rate=0.3),
    "swin-l": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
                   window=(1, 7, 7), out_norms=True, drop_path_rate=0.3),
}


def build_video_swin(name: str, use_remat: bool = False,
                     dtype: torch.dtype = torch.float32) -> VideoSwinBackbone:
    """The rate is the config's own drop_path_rate, else 0.2, as the JAX
    package's build_video_swin resolves it."""
    cfg = dict(SWIN_CONFIGS[name])
    return VideoSwinBackbone(
        patch_size=(1, 4, 4), window=cfg.pop("window", (8, 7, 7)),
        drop_path_rate=cfg.pop("drop_path_rate", 0.2),
        out_norms=cfg.pop("out_norms", False), patch_norm=True,
        use_remat=use_remat, dtype=dtype, **cfg)
