"""Deformable-DETR transformer (torch twin of
neurips2023_soc_tpu/models/deformable_transformer.py).

Spatial shapes are Python tuples; sequences are batch-major (B*T, S, C); the
deformable sampling is `ops.ms_deform_attn` (the CUDA kernel on the card).
Two-stage mode keeps the JAX package's repair of the reference: dedicated
encoder-stage heads (`enc_class_embed`, `enc_bbox_embed`) and padded or
out-of-frame proposals masked out of the top-k.

The per-layer box heads (`bbox_embed`) belong to SOC, as in the reference's
state_dict (`bbox_embed.{l}.*`); SOC hands them to `forward`.
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops import ms_deform_attn
from ..utils.boxes import inverse_sigmoid
from .common import MLP, Dropout, LayerNorm, Linear, MultiheadAttention, get_activation

SpatialShapes = Tuple[Tuple[int, int], ...]


def _offset_grid_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Direction-grid bias init for sampling offsets
    (reference models/ops/modules/ms_deform_attn.py:63-71)."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)  # (M, 2)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


@functools.lru_cache(maxsize=32)
def _wh_normalizer(spatial_shapes: SpatialShapes, device: torch.device) -> torch.Tensor:
    """(L, 2) xy sizes of the levels, made once per geometry and device so
    the forward uploads nothing."""
    return torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                        device=device)


class MSDeformAttnModule(nn.Module):
    """Query -> sampling offsets + attention weights -> deformable sampling."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.n_levels, self.n_heads, self.n_points = (
            d_model, n_levels, n_heads, n_points)
        self.dtype = dtype
        self.value_proj = Linear(d_model, d_model, dtype=dtype)
        self.sampling_offsets = Linear(d_model, 2 * n_heads * n_levels * n_points,
                                       dtype=dtype)
        self.attention_weights = Linear(d_model, n_heads * n_levels * n_points,
                                        dtype=dtype)
        self.output_proj = Linear(d_model, d_model, dtype=dtype)

    def init_params(self, generator):
        # zero kernels + direction-grid bias: the initial sampling points sit
        # on a grid around each reference point, weighted uniformly
        nn.init.zeros_(self.sampling_offsets.weight)
        self.sampling_offsets.bias.copy_(torch.from_numpy(
            _offset_grid_bias(self.n_heads, self.n_levels, self.n_points)))
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)

    def forward(self, query, reference_points, input_flatten,
                spatial_shapes: SpatialShapes, padding_mask=None):
        """query (B, Lq, C); reference_points (B, Lq, L, 2|4); input_flatten
        (B, S, C); padding_mask (B, S) True on padding."""
        M, L, P, C = self.n_heads, self.n_levels, self.n_points, self.d_model
        D = C // M
        B, Lq, _ = query.shape
        S = input_flatten.shape[1]

        value = self.value_proj(input_flatten)
        if padding_mask is not None:
            value = value.masked_fill(padding_mask[..., None], 0.0)
        value = value.view(B, S, M, D)

        offsets = self.sampling_offsets(query).view(B, Lq, M, L, P, 2)
        attn = self.attention_weights(query).view(B, Lq, M, L * P)
        attn = torch.softmax(attn.float(), dim=-1).to(self.dtype).view(B, Lq, M, L, P)

        if reference_points.shape[-1] == 2:
            normalizer = _wh_normalizer(spatial_shapes, query.device)
            loc = (reference_points[:, :, None, :, None, :]
                   + offsets / normalizer[None, None, None, :, None, :])
        else:
            loc = (reference_points[:, :, None, :, None, :2]
                   + offsets / P * reference_points[:, :, None, :, None, 2:] * 0.5)

        out = ms_deform_attn(value.contiguous(), spatial_shapes, loc.contiguous(),
                             attn.contiguous())
        return self.output_proj(out), loc, attn


class EncoderLayer(nn.Module):
    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points,
                 activation="relu", dtype=torch.float32, dropout=0.1):
        super().__init__()
        self.self_attn = MSDeformAttnModule(d_model, n_levels, n_heads, n_points, dtype)
        self.norm1 = LayerNorm(d_model, dtype=dtype)
        self.linear1 = Linear(d_model, d_ffn, dtype=dtype)
        self.linear2 = Linear(d_ffn, d_model, dtype=dtype)
        self.norm2 = LayerNorm(d_model, dtype=dtype)
        self.activation = get_activation(activation)
        self.drop = Dropout(dropout)

    def forward(self, src, pos, reference_points, spatial_shapes, padding_mask, rng=None):
        q = src if pos is None else src + pos
        src2, _, _ = self.self_attn(q, reference_points, src, spatial_shapes,
                                    padding_mask)
        src = self.norm1(src + self.drop(src2, rng))
        h = self.drop(self.activation(self.linear1(src)), rng)
        return self.norm2(src + self.drop(self.linear2(h), rng))


class DecoderLayer(nn.Module):
    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points,
                 activation="relu", dtype=torch.float32, dropout=0.1):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, n_heads, dtype, dropout)
        self.norm2 = LayerNorm(d_model, dtype=dtype)
        self.cross_attn = MSDeformAttnModule(d_model, n_levels, n_heads, n_points, dtype)
        self.norm1 = LayerNorm(d_model, dtype=dtype)
        self.linear1 = Linear(d_model, d_ffn, dtype=dtype)
        self.linear2 = Linear(d_ffn, d_model, dtype=dtype)
        self.norm3 = LayerNorm(d_model, dtype=dtype)
        self.activation = get_activation(activation)
        self.drop = Dropout(dropout)

    def forward(self, tgt, query_pos, reference_points, src, spatial_shapes,
                src_padding_mask, rng=None):
        q = tgt if query_pos is None else tgt + query_pos
        tgt = self.norm2(tgt + self.drop(self.self_attn(q, q, tgt, rng=rng), rng))
        q = tgt if query_pos is None else tgt + query_pos
        tgt2, loc, attn = self.cross_attn(q, reference_points, src, spatial_shapes,
                                          src_padding_mask)
        tgt = self.norm1(tgt + self.drop(tgt2, rng))
        h = self.drop(self.activation(self.linear1(tgt)), rng)
        tgt = self.norm3(tgt + self.drop(self.linear2(h), rng))
        return tgt, loc, attn


class _Layers(nn.Module):
    """`encoder.layers.{i}` / `decoder.layers.{i}` in the reference's keys."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


def encoder_reference_points(spatial_shapes: SpatialShapes,
                             valid_ratios: torch.Tensor) -> torch.Tensor:
    """(B, S, L, 2) per-token reference points."""
    dev = valid_ratios.device
    ref_list = []
    for lvl, (H, W) in enumerate(spatial_shapes):
        ry = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5)[:, None]
        rx = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5)[None, :]
        ry = ry.expand(H, W).reshape(-1)
        rx = rx.expand(H, W).reshape(-1)
        ry = ry[None] / (valid_ratios[:, None, lvl, 1] * H)
        rx = rx[None] / (valid_ratios[:, None, lvl, 0] * W)
        ref_list.append(torch.stack([rx, ry], -1))  # (B, H*W, 2)
    ref = torch.cat(ref_list, 1)
    return ref[:, :, None] * valid_ratios[:, None]


def proposal_pos_embed(proposals: torch.Tensor, d_model: int) -> torch.Tensor:
    """Sine embedding of (B, Nq, 4) unactivated proposal boxes ->
    (B, Nq, 2*d_model)."""
    num_pos_feats = d_model // 2
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=proposals.device)
    dim_t = 10000.0 ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)
    p = torch.sigmoid(proposals.float()) * (2.0 * math.pi)
    pos = p[..., None] / dim_t  # (B, Nq, 4, F)
    pos = torch.stack([torch.sin(pos[..., 0::2]), torch.cos(pos[..., 1::2])], -1)
    return pos.reshape(pos.shape[0], pos.shape[1], -1)


def compute_valid_ratios(masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-level (B, H, W) True=pad masks -> (B, L, 2) xy valid fraction."""
    ratios = []
    for m in masks:
        H, W = m.shape[1:]
        valid_h = (~m[:, :, 0]).sum(1).float()
        valid_w = (~m[:, 0, :]).sum(1).float()
        ratios.append(torch.stack([valid_w / W, valid_h / H], -1))
    return torch.stack(ratios, 1)


class DeformableTransformer(nn.Module):
    def __init__(self, d_model: int = 256, n_heads: int = 8,
                 num_encoder_layers: int = 3, num_decoder_layers: int = 3,
                 dim_feedforward: int = 2048, activation: str = "relu",
                 num_feature_levels: int = 4, dec_n_points: int = 4,
                 enc_n_points: int = 4, two_stage: bool = False, two_stage_num_proposals: int = 300,
                 num_classes: int = 1, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.1):
        super().__init__()
        self.d_model, self.dtype = d_model, dtype
        self.num_feature_levels = num_feature_levels
        self.two_stage = two_stage
        self.two_stage_num_proposals = two_stage_num_proposals
        kw = dict(d_model=d_model, d_ffn=dim_feedforward, n_levels=num_feature_levels,
                  n_heads=n_heads, activation=activation, dtype=dtype, dropout=dropout)
        self.encoder = _Layers(EncoderLayer(n_points=enc_n_points, **kw)
                               for _ in range(num_encoder_layers))
        self.decoder = _Layers(DecoderLayer(n_points=dec_n_points, **kw)
                               for _ in range(num_decoder_layers))
        self.level_embed = nn.Parameter(torch.empty(num_feature_levels, d_model))
        if two_stage:
            self.enc_output = Linear(d_model, d_model, dtype=dtype)
            self.enc_output_norm = LayerNorm(d_model, dtype=dtype)
            self.pos_trans = Linear(2 * d_model, 2 * d_model, dtype=dtype)
            self.pos_trans_norm = LayerNorm(2 * d_model, dtype=dtype)
            self.enc_class_embed = Linear(d_model, num_classes, dtype=dtype)
            self.enc_bbox_embed = MLP(d_model, d_model, 4, 3, dtype=dtype)
        else:
            self.reference_points = Linear(d_model, 2, dtype=dtype)

    def init_params(self, generator):
        nn.init.normal_(self.level_embed, std=1.0, generator=generator)

    def gen_encoder_output_proposals(self, memory, padding_mask,
                                     spatial_shapes: SpatialShapes):
        """Per-token anchor proposals + projected memory. Returns
        (output_memory (B,S,C), output_proposals (B,S,4) unactivated, +inf at
        padded / out-of-frame tokens)."""
        B, dev = memory.shape[0], memory.device
        proposals, cur = [], 0
        for lvl, (H, W) in enumerate(spatial_shapes):
            m = padding_mask[:, cur:cur + H * W].reshape(B, H, W)
            valid_h = (~m[:, :, 0]).sum(1).float()
            valid_w = (~m[:, 0, :]).sum(1).float()
            gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                                    torch.arange(W, dtype=torch.float32, device=dev),
                                    indexing="ij")
            grid = torch.stack([gx, gy], -1)  # (H, W, 2) xy
            scale = torch.stack([valid_w, valid_h], -1).view(B, 1, 1, 2)
            grid = (grid[None] + 0.5) / scale
            wh = torch.full_like(grid, 0.05 * (2.0 ** lvl))
            proposals.append(torch.cat([grid, wh], -1).reshape(B, H * W, 4))
            cur += H * W
        props = torch.cat(proposals, 1)
        valid = ((props > 0.01) & (props < 0.99)).all(-1, keepdim=True)
        safe = props.clamp(1e-6, 1.0 - 1e-6)
        props_unact = torch.log(safe / (1.0 - safe))
        drop = padding_mask[..., None] | ~valid
        props_unact = props_unact.masked_fill(drop, float("inf"))
        out_mem = memory.masked_fill(drop, 0.0)
        out_mem = self.enc_output_norm(self.enc_output(out_mem))
        return out_mem, props_unact

    def forward(self, srcs: List[torch.Tensor], masks: List[torch.Tensor],
                pos_embeds: List[torch.Tensor], query_embed: Optional[torch.Tensor],
                bbox_embed: Sequence[nn.Module], rng: Optional[torch.Generator] = None):
        """srcs/pos_embeds: per level (B*T, H, W, C); masks: per level
        (B*T, H, W) True=pad; query_embed (Nq, C), None when two_stage;
        bbox_embed: the per-decoder-layer box heads; rng: the dropout
        generator (None: no dropout)."""
        spatial_shapes = tuple((s.shape[1], s.shape[2]) for s in srcs)
        src_flat = torch.cat([s.reshape(s.shape[0], -1, s.shape[-1]) for s in srcs], 1)
        mask_flat = torch.cat([m.reshape(m.shape[0], -1) for m in masks], 1)
        pos_flat = torch.cat(
            [p.reshape(p.shape[0], -1, p.shape[-1])
             + self.level_embed[lvl][None, None].to(self.dtype)
             for lvl, p in enumerate(pos_embeds)], 1)
        valid_ratios = compute_valid_ratios(masks)  # (B*T, L, 2)

        enc_ref = encoder_reference_points(spatial_shapes, valid_ratios)
        memory = src_flat
        for layer in self.encoder.layers:
            memory = layer(memory, pos_flat, enc_ref, spatial_shapes, mask_flat, rng)

        B = memory.shape[0]
        enc_outputs = None
        if self.two_stage:
            output_memory, output_proposals = self.gen_encoder_output_proposals(
                memory, mask_flat, spatial_shapes)
            enc_class = self.enc_class_embed(output_memory).float()
            enc_coord_unact = (self.enc_bbox_embed(output_memory).float()
                               + output_proposals)
            score = torch.where(torch.isfinite(output_proposals[..., 0]),
                                enc_class[..., 0], float("-inf"))
            k = min(self.two_stage_num_proposals, score.shape[1])
            topk_idx = torch.topk(score, k, dim=1).indices
            topk_coords_unact = torch.gather(
                enc_coord_unact, 1, topk_idx[..., None].expand(B, k, 4)).detach()
            reference_points = torch.sigmoid(topk_coords_unact)  # (B, K, 4)
            pos_trans_out = self.pos_trans_norm(self.pos_trans(
                proposal_pos_embed(topk_coords_unact, self.d_model).to(self.dtype)))
            qe, tgt = torch.chunk(pos_trans_out, 2, dim=-1)
            enc_outputs = (enc_class, enc_coord_unact)
        else:
            Nq = query_embed.shape[0]
            qe = query_embed[None].expand(B, Nq, query_embed.shape[1]).to(self.dtype)
            tgt = torch.zeros_like(qe)
            reference_points = torch.sigmoid(self.reference_points(qe).float())
        init_reference = reference_points

        hs_list, ref_list = [], []
        for lid, layer in enumerate(self.decoder.layers):
            if reference_points.shape[-1] == 4:
                ref_input = (reference_points[:, :, None]
                             * torch.cat([valid_ratios, valid_ratios], -1)[:, None])
            else:
                ref_input = reference_points[:, :, None] * valid_ratios[:, None]
            tgt, _, _ = layer(tgt, qe, ref_input, memory, spatial_shapes, mask_flat, rng)
            # box refinement (every config refines)
            tmp = bbox_embed[lid](tgt).float()
            if reference_points.shape[-1] == 4:
                new_ref = torch.sigmoid(tmp + inverse_sigmoid(reference_points))
            else:
                xy = tmp[..., :2] + inverse_sigmoid(reference_points)
                new_ref = torch.sigmoid(torch.cat([xy, tmp[..., 2:]], -1))
            # no gradient through the refined references (JAX stop_gradient)
            reference_points = new_ref.detach()
            hs_list.append(tgt)
            ref_list.append(reference_points)

        hs = torch.stack(hs_list)  # (Lyr, B*T, Nq, C)
        inter_references = torch.stack(ref_list)  # (Lyr, B*T, Nq, 2|4)

        # encoder memory back into maps for the first L-1 levels (FPN inputs)
        memory_features, start = [], 0
        for lvl in range(self.num_feature_levels - 1):
            H, W = spatial_shapes[lvl]
            memory_features.append(
                memory[:, start:start + H * W].reshape(B, H, W, self.d_model))
            start += H * W
        return hs, memory_features, init_reference, inter_references, enc_outputs
