"""FPN spatial decoder + CondInst-style dynamic mask head (a frozen copy of the
port's models/segmentation.py). The per-query 1x1 conv net runs
as batched einsums over the clip, in float32."""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resize import aligned_bilinear, resize_nearest
from .common import Conv2d, GroupNorm


class FPNSpatialDecoder(nn.Module):
    """Top-down FPN over encoder memory (+ the stride-4 backbone feature).

    fpn_dims: channels of the adapter inputs, high -> low resolution order;
    the coarsest input `x` has `context_dim` channels."""

    def __init__(self, context_dim: int, fpn_dims: Sequence[int],
                 mask_kernels_dim: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        cd = context_dim
        inter = [cd, cd // 2, cd // 4, cd // 8, cd // 16]
        self.num_adapters = len(fpn_dims)
        n_lay = 5 if self.num_adapters == 3 else 4
        ins = [cd] + inter[: n_lay - 1]
        for i in range(n_lay):
            self.add_module(f"lay{i + 1}", Conv2d(ins[i], inter[i], 3, padding=1,
                                                  dtype=dtype))
            self.add_module(f"gn{i + 1}", GroupNorm(min(8, inter[i]), inter[i],
                                                    dtype=dtype))
        for i, dim in enumerate(fpn_dims):
            self.add_module(f"adapter{i + 1}", Conv2d(dim, inter[i + 1], 1, dtype=dtype))
        self.out_lay = Conv2d(inter[n_lay - 1], mask_kernels_dim, 3, padding=1,
                              dtype=dtype)

    def _conv_gn_relu(self, y, idx):
        return F.relu(getattr(self, f"gn{idx}")(getattr(self, f"lay{idx}")(y)))

    def forward(self, x: torch.Tensor, layer_features: List[torch.Tensor]):
        """x: (B, H, W, C) coarsest memory; layer_features: finer maps."""
        x = self._conv_gn_relu(x, 1)
        x = self._conv_gn_relu(x, 2)
        for i in range(self.num_adapters):
            cur = getattr(self, f"adapter{i + 1}")(layer_features[i])
            x = cur + resize_nearest(x, cur.shape[-3], cur.shape[-2])
            x = self._conv_gn_relu(x, i + 3)
        return self.out_lay(x)


def mask_head_param_split(in_channels: int, channels: int, num_layers: int,
                          rel_coord: bool) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Per-layer weight/bias sizes of the dynamic conv net."""
    weight_nums, bias_nums = [], []
    for l in range(num_layers):
        if l == 0:
            cin = in_channels + 2 if rel_coord else in_channels
            weight_nums.append(cin * channels)
            bias_nums.append(channels)
        elif l == num_layers - 1:
            weight_nums.append(channels)
            bias_nums.append(1)
        else:
            weight_nums.append(channels * channels)
            bias_nums.append(channels)
    return tuple(weight_nums), tuple(bias_nums)


def compute_locations(h: int, w: int, stride: int, device=None) -> torch.Tensor:
    """Pixel-center locations of a stride-s feature map in image coords,
    (h, w, 2) xy."""
    sx = torch.arange(w, dtype=torch.float32, device=device) * stride + stride // 2
    sy = torch.arange(h, dtype=torch.float32, device=device) * stride + stride // 2
    return torch.stack([sx[None, :].expand(h, w), sy[:, None].expand(h, w)], -1)


def dynamic_mask_with_coords(
    mask_features: torch.Tensor,  # (B, T, H, W, Cm)
    mask_head_params: torch.Tensor,  # (B, T*Nq, num_params)
    reference_points: torch.Tensor,  # (B, T*Nq, 2) cxcy normalized [0, 1]
    image_size: Union[Tuple[int, int], torch.Tensor],  # (img_h, img_w) or (B, 2)
    channels: int,
    num_layers: int,
    rel_coord: bool = True,
    mask_feat_stride: int = 4,
    mask_out_stride: int = 4,
) -> torch.Tensor:
    """Run the per-query dynamic conv net over the clip; returns mask logits
    (B, T*Nq, H_out, W_out), float32."""
    B, T, H, W, Cm = mask_features.shape
    Q = mask_head_params.shape[1] // T
    mf = mask_features.float()
    params = mask_head_params.float()

    if rel_coord:
        ref = reference_points.float()
        if isinstance(image_size, tuple):
            img_h, img_w = image_size
            ref = torch.stack([ref[..., 0] * img_w, ref[..., 1] * img_h], -1)
        else:
            size = image_size.float().view(-1, 1, 2)  # (B|1, 1, 2) as (h, w)
            ref = ref * size.flip(-1)
        ref = ref.view(B, T, Q, 2)
        locs = compute_locations(H, W, mask_feat_stride, mf.device)
        rel = ref[:, :, :, None, None, :] - locs[None, None, None]  # (B,T,Q,H,W,2)
        x = torch.cat([mf[:, :, None].expand(B, T, Q, H, W, Cm), rel], -1)
    else:
        x = mf[:, :, None].expand(B, T, Q, H, W, Cm)

    weight_nums, bias_nums = mask_head_param_split(Cm, channels, num_layers, rel_coord)
    p = params.view(B, T, Q, -1)
    splits = torch.split(p, list(weight_nums) + list(bias_nums), dim=-1)
    weights, biases = splits[:num_layers], splits[num_layers:]

    cin = Cm + 2 if rel_coord else Cm
    for l in range(num_layers):
        cout = 1 if l == num_layers - 1 else channels
        wl = weights[l].reshape(B, T, Q, cout, cin)
        bl = biases[l].reshape(B, T, Q, cout)
        x = torch.einsum("btqhwc,btqoc->btqhwo", x, wl) + bl[:, :, :, None, None, :]
        if l < num_layers - 1:
            x = F.relu(x)
        cin = cout

    logits = x[..., 0]  # (B, T, Q, H, W)
    factor = mask_feat_stride // mask_out_stride
    if factor > 1:
        logits = aligned_bilinear(logits[..., None], factor)[..., 0]
    return logits.reshape(B, T * Q, logits.shape[-2], logits.shape[-1])
