"""VOC — Video Object Cluster (torch twin of neurips2023_soc_tpu/models/voc.py),
the paper's temporal aggregation module.

Takes per-decoder-layer frame queries (Lyr, T, B, Nq, C) and the pooled
sentence feature (B, C); runs a (shifted-)window or full temporal
self-attention encoder over frames, then a cross-attention decoder whose video
queries start from the language feature. As in the JAX package, the (Lyr, T,
B) axes are regrouped explicitly as (Lyr*B, T, Nq, C) — the reference's raw
reshape (models/voc.py:282) is right only for B == 1.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from .common import (CrossAttentionLayer, Embedding, FFNLayer, LayerNorm,
                     SelfAttentionLayer)


class VOC(nn.Module):
    def __init__(self, input_dim: int = 256, window_size: int = 0,
                 num_frame_queries: int = 20, num_queries: int = 20, num_heads: int = 8,
                 dim_feedforward: int = 2048, enc_layers: int = 3, dec_layers: int = 3,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.1):
        super().__init__()
        C = input_dim
        self.window_size, self.num_queries, self.num_heads = (
            window_size, num_queries, num_heads)
        self.dtype = dtype
        self.fq_pos = Embedding(num_frame_queries, C)
        self.query_embed = Embedding(num_queries, C)
        self.decoder_norm = LayerNorm(C, dtype=dtype)
        kw = dict(dtype=dtype, dropout=dropout)
        self.enc_self_attn = nn.ModuleList(
            SelfAttentionLayer(C, num_heads, **kw) for _ in range(enc_layers))
        self.enc_ffn = nn.ModuleList(
            FFNLayer(C, dim_feedforward, **kw) for _ in range(enc_layers))
        self.transformer_cross_attention_layers = nn.ModuleList(
            CrossAttentionLayer(C, num_heads, **kw) for _ in range(dec_layers))
        self.transformer_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(C, num_heads, **kw) for _ in range(dec_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            FFNLayer(C, dim_feedforward, **kw) for _ in range(dec_layers))

    def _encode_full(self, fq: torch.Tensor, rng) -> torch.Tensor:
        """Full temporal attention over all T*Nq tokens (window_size == 0)."""
        LB, T, Nq, C = fq.shape
        x = fq.reshape(LB, T * Nq, C)
        for attn, ffn in zip(self.enc_self_attn, self.enc_ffn):
            x = ffn(attn(x, rng=rng), rng)
        return x.reshape(LB, T, Nq, C)

    def _window_masks(self, T: int, t_valid: int, Nq: int, LB: int, device):
        """Key padding mask of the plain windows (LB*Nw, W*Nq) and additive
        mask of the shifted windows (LB*Nw*heads, W*Nq, W*Nq), built with
        numpy (they depend only on the shapes) and uploaded once per call."""
        W = self.window_size
        Nw, half = T // W, math.ceil(W / 2)
        frame_pad = np.arange(T) >= t_valid
        win_pad = np.repeat(frame_pad.reshape(Nw, W), Nq, axis=1)
        win_pad = np.broadcast_to(win_pad[None], (LB, Nw, W * Nq)).reshape(LB * Nw, W * Nq)
        rolled = np.roll(frame_pad, half).reshape(Nw, W)
        m = np.broadcast_to(rolled[:, None, :], (Nw, W, W)).copy()
        edge = (np.arange(Nw) % max(Nw - 1, 1) == 0)[:, None, None]
        m = m | (m.transpose(0, 2, 1) & edge)
        first = np.zeros((W, W), bool)
        first[:half, half:] = True
        first[half:, :half] = True
        m[0] |= first
        shift = np.where(m, -1000.0, 0.0).astype(np.float32)
        shift = np.repeat(np.repeat(shift, Nq, axis=1), Nq, axis=2)  # (Nw, WNq, WNq)
        to = dict(device=device)
        shift = torch.from_numpy(shift).to(**to)
        shift = shift[None, :, None].expand(LB, Nw, self.num_heads, W * Nq, W * Nq)
        shift = shift.reshape(LB * Nw * self.num_heads, W * Nq, W * Nq)
        return torch.from_numpy(np.ascontiguousarray(win_pad)).to(**to), shift

    def _encode_windowed(self, fq: torch.Tensor, t_valid: int, training: bool,
                         rng) -> torch.Tensor:
        """(Shifted-)window temporal attention. At inference even layers use
        plain windows and odd layers shifted ones; in training every layer
        uses plain windows (JAX voc.py:133, `training or i % 2 == 0`).
        fq: (LB, T, Nq, C), T a multiple of window_size; frames >= t_valid
        are padding."""
        LB, T, Nq, C = fq.shape
        W = self.window_size
        Nw, half = T // W, math.ceil(W / 2)
        win_pad, shift_mask = self._window_masks(T, t_valid, Nq, LB, fq.device)
        x = fq
        for i, (attn, ffn) in enumerate(zip(self.enc_self_attn, self.enc_ffn)):
            if training or i % 2 == 0:
                xw = x.reshape(LB * Nw, W * Nq, C)
                xw = ffn(attn(xw, tgt_key_padding_mask=win_pad, rng=rng), rng)
                x = xw.reshape(LB, T, Nq, C)
            else:
                xw = torch.roll(x, half, dims=1).reshape(LB * Nw, W * Nq, C)
                xw = ffn(attn(xw, tgt_mask=shift_mask, rng=rng), rng)
                x = torch.roll(xw.reshape(LB, T, Nq, C), -half, dims=1)
        return x

    def forward(self, frame_query: torch.Tensor, language_query: torch.Tensor,
                training: bool = False, rng=None) -> torch.Tensor:
        """frame_query (Lyr, T, B, Nq, C); language_query (B, C) ->
        (Lyr', B, num_queries, C): inference uses the last layer only
        (Lyr' = 1), training every layer. rng: the dropout generator."""
        if not training:
            frame_query = frame_query[-1:]
        Lyr, T, B, Nq, C = frame_query.shape
        LB = Lyr * B
        fq = frame_query.permute(0, 2, 1, 3, 4).reshape(LB, T, Nq, C).to(self.dtype)

        if self.window_size > 0:
            pad = (-T) % self.window_size
            fq_p = torch.nn.functional.pad(fq, (0, 0, 0, 0, 0, pad))
            fq = self._encode_windowed(fq_p, T, training, rng)[:, :T]
        else:
            fq = self._encode_full(fq, rng)

        src = fq.reshape(LB, T * Nq, C)
        # pos for token (t, nq) is fq_pos[nq]
        dec_pos = self.fq_pos.weight.to(self.dtype)[None, :Nq].repeat(LB, T, 1)
        qe = self.query_embed.weight.to(self.dtype)[None].expand(LB, self.num_queries, C)
        out = language_query.to(self.dtype)[None, :, None, :].expand(
            Lyr, B, self.num_queries, C).reshape(LB, self.num_queries, C)
        for cross, self_attn, ffn in zip(self.transformer_cross_attention_layers,
                                         self.transformer_self_attention_layers,
                                         self.transformer_ffn_layers):
            out = cross(out, src, pos=dec_pos, query_pos=qe, rng=rng)
            out = self_attn(out, query_pos=qe, rng=rng)
            out = ffn(out, rng)
        return self.decoder_norm(out).reshape(Lyr, B, self.num_queries, C)
