"""SOC — Semantic-assisted Object Cluster, the composition root (torch twin of
neurips2023_soc_tpu/models/soc.py).

Channels-last and batch-major; time is folded into batch b-major, `(b t)`
rows, for all per-frame stages. Outputs, as in the JAX package:
  pred_masks:  (Le, T, B, Nq, H/4, W/4)
  pred_cls:    (Le, T, B, Nq, K)
  pred_boxes:  (Le, T, B, Nq, 4)
  pred_logit:  (Le, B, Nq, C)
  text_sentence_feature: (B, C)
where Le = 1 at inference with vl_loss on: the reference's deployed inference
scores the layer-0 queries with the layer-0 heads (its zip truncation,
neurips2023_soc_tpu/models/soc.py:338-356), and Le = dec_layers otherwise and
in training.

Training mode (`training=True`, with `rng`, a torch.Generator on the model's
device): every decoder layer goes through VOC and the heads, and dropout
(transformer `dropout`, VOC and txt_proj 0.1) and the backbone's drop path
draw their masks from `rng`. A frozen text encoder runs without dropout and
passes no gradient back (JAX stop_gradient); its parameters stay in the
optimizer's view with no gradient.

Parameter names are the reference SOC's state_dict keys, so a JAX parameter
tree converts (convert.py) and loads with strict=True.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn

from ..ops import downsample_mask_nearest
from ..utils.boxes import inverse_sigmoid
from ..utils.logging import span
from .common import MLP, MMF, Conv2d, Embedding, FeatureResizer, GroupNorm, Linear
from .deformable_transformer import DeformableTransformer
from .position_encoding import position_embedding_sine_1d, position_embedding_sine_2d
from .resnet import ResNet50Backbone
from .segmentation import FPNSpatialDecoder, dynamic_mask_with_coords, mask_head_param_split
from .text_encoder import ROBERTA_CONFIGS, RobertaEncoder
from .video_swin import SWIN_CONFIGS, build_video_swin
from .voc import VOC


class _BackboneBody(nn.Module):
    """`backbone.0.body` in the reference's keys."""

    def __init__(self, body: nn.Module):
        super().__init__()
        self.body = body


class SOC(nn.Module):
    def __init__(self, backbone_name: str = "video-swin-t", num_classes: int = 1,
                 d_model: int = 256, num_queries: int = 20, num_feature_levels: int = 4,
                 nheads: int = 8, enc_layers: int = 3, dec_layers: int = 3,
                 dim_feedforward: int = 2048, enc_n_points: int = 4,
                 dec_n_points: int = 4, with_box_refine: bool = True,
                 two_stage: bool = False, two_stage_num_proposals: int = 300,
                 rel_coord: bool = True, mask_kernels_dim: int = 8,
                 controller_layers: int = 3, dynamic_mask_channels: int = 8,
                 voc_window_size: int = 0, voc_enc_layers: int = 3,
                 voc_dec_layers: int = 3, text_encoder_type: str = "roberta-base",
                 vl_loss: bool = True, use_remat: bool = False,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.1,
                 freeze_text_encoder: bool = True, swin_attn_impl: str = "xla"):
        super().__init__()
        if backbone_name not in SWIN_CONFIGS and backbone_name != "resnet50":
            raise ValueError(f"unknown backbone {backbone_name} "
                             f"(this port has {sorted(SWIN_CONFIGS) + ['resnet50']})")
        if not with_box_refine:
            # every config refines boxes; the JAX package's shared heads
            # (`*_shared`) have no reference state_dict key to load from
            raise ValueError("with_box_refine=False is not supported by the port")
        C = d_model
        self.d_model, self.dtype = d_model, dtype
        self.num_feature_levels = num_feature_levels
        self.vl_loss, self.rel_coord = vl_loss, rel_coord
        self.freeze_text_encoder = freeze_text_encoder
        self.mask_kernels_dim = mask_kernels_dim
        self.controller_layers = controller_layers
        self.dynamic_mask_channels = dynamic_mask_channels
        if backbone_name == "resnet50":
            # swin_attn_impl does not apply; the convolutions run in cuDNN
            body = ResNet50Backbone(dtype)
            backbone_channels = [256, 512, 1024, 2048]
        else:
            body = build_video_swin(backbone_name, use_remat, dtype, swin_attn_impl)
            embed = SWIN_CONFIGS[backbone_name]["embed_dim"]
            backbone_channels = [embed * 2 ** i for i in range(4)]
        self.backbone = nn.ModuleList([_BackboneBody(body)])

        self.transformer = DeformableTransformer(
            d_model=C, n_heads=nheads, num_encoder_layers=enc_layers,
            num_decoder_layers=dec_layers, dim_feedforward=dim_feedforward,
            num_feature_levels=num_feature_levels, dec_n_points=dec_n_points,
            enc_n_points=enc_n_points, two_stage=two_stage, two_stage_num_proposals=two_stage_num_proposals,
            num_classes=num_classes, dtype=dtype, dropout=dropout)
        # two-stage replaces the Nq learned queries with top-k proposals
        eff_nq = two_stage_num_proposals if two_stage else num_queries
        self.voc = VOC(input_dim=C, window_size=voc_window_size,
                       num_frame_queries=eff_nq, num_queries=eff_nq, num_heads=nheads,
                       dim_feedforward=dim_feedforward, enc_layers=voc_enc_layers,
                       dec_layers=voc_dec_layers, dtype=dtype)
        name = text_encoder_type.split("/")[-1]
        text_cfg = ROBERTA_CONFIGS.get(name, ROBERTA_CONFIGS["roberta-base"])
        self.text_encoder = RobertaEncoder(text_cfg, dtype=dtype)
        # txt_proj runs in float32 in the JAX model (it is given no dtype)
        self.txt_proj = FeatureResizer(text_cfg.hidden_size, C, dtype=torch.float32,
                                       dropout=0.1)
        self.vlf = MMF(C, nheads, dtype=dtype)
        self.lvf = MMF(C, nheads, dtype=dtype)

        # input projections: 1x1 conv + GN(32) for backbone levels 2..4, plus
        # a stride-2 3x3 conv for each extra pyramid level
        projs = []
        for i in range(num_feature_levels):
            if i < 3:
                conv = Conv2d(backbone_channels[i + 1], C, 1, dtype=dtype)
            else:
                in_ch = backbone_channels[-1] if i == 3 else C
                conv = Conv2d(in_ch, C, 3, stride=2, padding=1, dtype=dtype)
            projs.append(nn.ModuleList([conv, GroupNorm(32, C, dtype=dtype)]))
        self.input_proj = nn.ModuleList(projs)

        self.query_embed = None if two_stage else Embedding(num_queries, C)
        self.bias_value = -math.log((1 - 0.01) / 0.01)
        self.class_embed = nn.ModuleList(
            Linear(C, num_classes, dtype=dtype) for _ in range(dec_layers))
        self.bbox_embed = nn.ModuleList(
            MLP(C, C, 4, 3, dtype=dtype) for _ in range(dec_layers))

        weight_nums, bias_nums = mask_head_param_split(
            mask_kernels_dim, dynamic_mask_channels, controller_layers, rel_coord)
        self.num_gen_params = sum(weight_nums) + sum(bias_nums)
        self.controller = MLP(C, C, self.num_gen_params, 3, dtype=dtype)
        self.spatial_decoder = FPNSpatialDecoder(
            C, [C, C, backbone_channels[0]], mask_kernels_dim, dtype=dtype)

    def init_params(self, generator):
        for head in self.class_embed:
            nn.init.constant_(head.bias, self.bias_value)

    def encode_text(self, text_ids, text_mask, rng=None):
        """RoBERTa -> txt_proj'd token sequence + sentence feature. A frozen
        encoder runs without dropout and without autograd (JAX stop_gradient)."""
        if self.freeze_text_encoder:
            with torch.no_grad():
                last_hidden, pooled = self.text_encoder(text_ids, text_mask)
        else:
            last_hidden, pooled = self.text_encoder(text_ids, text_mask, rng)
        return (self.txt_proj(last_hidden, rng), self.txt_proj(pooled, rng),
                text_mask == 0)

    @staticmethod
    def _dropout_rng(training: bool, rng: Optional[torch.Generator]):
        if not training:
            return None
        if rng is None:
            raise ValueError("training mode draws dropout and drop-path masks: pass "
                             "rng, a torch.Generator on the model's device")
        return rng

    def backbone_features(self, pixels: torch.Tensor, pad_mask: torch.Tensor = None,
                          training: bool = False,
                          rng: Optional[torch.Generator] = None):
        """The text-independent stage: pixels (T, B, H, W, 3) -> b-major
        (B*T, Hi, Wi, Ci) maps per level. `pad_mask` is unused; it keeps the
        stage's signature that of the whole clip. Training applies drop path."""
        with span("soc.backbone"):
            video = pixels.permute(1, 0, 2, 3, 4).to(self.dtype)
            return self.backbone[0].body(video, self._dropout_rng(training, rng))

    def head(self, features, pad_mask: torch.Tensor, text_ids: torch.Tensor,
             text_mask: torch.Tensor, sample_sizes: Optional[torch.Tensor] = None,
             valid_indices: Optional[torch.Tensor] = None, training: bool = False,
             rng: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The text-dependent stage: text encoding, fusion, deformable
        transformer, VOC, heads, dynamic masks. pad_mask (T, B, H, W) True on
        padding; text_ids/text_mask (B, S)."""
        with span("soc.head"):
            return self._head(features, pad_mask, text_ids, text_mask, sample_sizes,
                              valid_indices, training, rng)

    def _head(self, features, pad_mask, text_ids, text_mask, sample_sizes, valid_indices,
              training, rng) -> Dict[str, torch.Tensor]:
        Tfull, B, H, W = pad_mask.shape
        C, dt = self.d_model, self.dtype
        rng = self._dropout_rng(training, rng)

        with span("soc.head.text"):
            text_word_features, text_sentence_feature, txt_pad_mask = self.encode_text(
                text_ids, text_mask, rng)
            text_pos = position_embedding_sine_1d(txt_pad_mask, C).to(dt)

        with span("soc.head.fusion"):
            pad_bt = pad_mask.permute(1, 0, 2, 3).reshape(B * Tfull, H, W)
            feat_masks = [downsample_mask_nearest(pad_bt, f.shape[1], f.shape[2])
                          for f in features]
            if valid_indices is not None:
                # keep only the annotated frames; T collapses to 1
                rows = torch.arange(B, device=pad_mask.device) * Tfull + valid_indices
                features = [f[rows] for f in features]
                feat_masks = [m[rows] for m in feat_masks]
                pad_bt = pad_bt[rows]
                T = 1
            else:
                T = Tfull

            srcs, masks, poses, langs = [], [], [], []
            for l, (feat, fmask) in enumerate(zip(features[-3:], feat_masks[-3:])):
                conv, gn = self.input_proj[l]
                src = gn(conv(feat))  # (B*T, h, w, C)
                _, h, w, _ = src.shape
                pos_l = position_embedding_sine_2d(fmask, C // 2).to(dt)
                seq = src.reshape(B, T * h * w, C)
                fused = self.vlf(seq, text_word_features,
                                 memory_key_padding_mask=txt_pad_mask, pos=text_pos)
                # the reference passes the vision 2D sine PE as the memory pos
                lan = self.lvf(text_word_features, seq,
                               memory_key_padding_mask=fmask.reshape(B, T * h * w),
                               pos=pos_l.reshape(B, T * h * w, C))
                srcs.append(fused.reshape(B * T, h, w, C))
                masks.append(fmask)
                poses.append(pos_l)
                langs.append(lan)

            for l in range(3, self.num_feature_levels):
                conv, gn = self.input_proj[l]
                src = gn(conv(features[-1] if l == 3 else srcs[-1]))
                _, h, w, _ = src.shape
                m = downsample_mask_nearest(pad_bt, h, w)
                pos_l = position_embedding_sine_2d(m, C // 2).to(dt)
                fused = self.vlf(src.reshape(B, T * h * w, C), text_word_features,
                                 memory_key_padding_mask=txt_pad_mask, pos=text_pos)
                srcs.append(fused.reshape(B * T, h, w, C))
                masks.append(m)
                poses.append(pos_l)

        # the transformer opens soc.head.encoder and soc.head.decoder
        query_embed = None if self.query_embed is None else self.query_embed.weight
        hs, memory_features, init_reference, inter_references, enc_outputs = (
            self.transformer(srcs, masks, poses, query_embed, self.bbox_embed, rng))
        Lyr, Nq = hs.shape[0], hs.shape[2]

        with span("soc.head.voc"):
            # rows are b-major (b t); a slip to t-major here still passes at B = 1,
            # which is why the parity tests run at B = 2
            hs_tb = hs.view(Lyr, B, T, Nq, C).permute(0, 2, 1, 3, 4)  # (L, T, B, Nq, C)
            # (Lyr, B, Nq, C) in training; (1, B, Nq, C), the last layer's, at
            # inference, broadcast back over the layers
            voc_hs = self.voc(hs_tb, text_sentence_feature, training, rng)
            if training or not self.vl_loss:
                emit_layers = tuple(range(Lyr))
            else:
                emit_layers = (0,)
            if not training:
                voc_hs = voc_hs.expand(Lyr, B, Nq, C)
            hs_voc = hs_tb + voc_hs[:, None]
            hs_voc_flat = hs_voc.permute(0, 2, 1, 3, 4).reshape(Lyr, B * T, Nq, C)

        with span("soc.head.outputs"):
            cls_list, box_list = [], []
            for lvl in emit_layers:
                reference = init_reference if lvl == 0 else inter_references[lvl - 1]
                reference = inverse_sigmoid(reference)
                tmp = self.bbox_embed[lvl](hs_voc_flat[lvl]).float()
                if reference.shape[-1] == 4:
                    tmp = tmp + reference
                else:
                    tmp = torch.cat([tmp[..., :2] + reference, tmp[..., 2:]], -1)
                box_list.append(torch.sigmoid(tmp))
                cls_list.append(self.class_embed[lvl](hs_voc_flat[lvl]))
            outputs_class = torch.stack(cls_list)  # (Le, B*T, Nq, K)
            outputs_coord = torch.stack(box_list)  # (Le, B*T, Nq, 4)

            # FPN mask features at stride 4
            mask_feat = self.spatial_decoder(
                memory_features[-1], [memory_features[1], memory_features[0], features[0]])
            hm, wm = mask_feat.shape[1:3]
            mask_features = mask_feat.reshape(B, T, hm, wm, self.mask_kernels_dim)
            image_size = (H, W) if sample_sizes is None else sample_sizes

            mask_list = []
            for lvl in emit_layers:
                params = self.controller(hs_voc_flat[lvl]).reshape(B, T * Nq,
                                                                   self.num_gen_params)
                refs = inter_references[lvl][..., :2].reshape(B, T * Nq, 2)
                seg = dynamic_mask_with_coords(
                    mask_features, params, refs, image_size,
                    channels=self.dynamic_mask_channels, num_layers=self.controller_layers,
                    rel_coord=self.rel_coord)
                mask_list.append(seg.view(B, T, Nq, hm, wm).transpose(0, 1))

            # sentence feature for the vl loss: mean of the last fused level's
            # non-pad text tokens, in float32
            valid = (~txt_pad_mask).float()[..., None]
            text_features = (langs[-1].float() * valid).sum(1) / valid.sum(1).clamp(min=1.0)
            Le = len(emit_layers)
            out = {
                "pred_masks": torch.stack(mask_list),
                "pred_cls": outputs_class.view(Le, B, T, Nq, -1).transpose(1, 2),
                "pred_boxes": outputs_coord.view(Le, B, T, Nq, 4).transpose(1, 2),
                "pred_logit": voc_hs[:len(emit_layers)],
                "text_sentence_feature": text_features,
            }
            if enc_outputs is not None:
                out["enc_outputs"] = {"pred_cls": enc_outputs[0],
                                      "pred_boxes_unact": enc_outputs[1]}
        return out

    def forward(self, pixels: torch.Tensor, pad_mask: torch.Tensor,
                text_ids: torch.Tensor, text_mask: torch.Tensor,
                sample_sizes: Optional[torch.Tensor] = None,
                valid_indices: Optional[torch.Tensor] = None, training: bool = False,
                rng: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """pixels (T, B, H, W, 3); pad_mask (T, B, H, W) True on padding;
        text_ids/text_mask (B, S); training=True needs rng (dropout masks)."""
        features = self.backbone_features(pixels, pad_mask, training, rng)
        return self.head(features, pad_mask, text_ids, text_mask,
                         sample_sizes=sample_sizes, valid_indices=valid_indices,
                         training=training, rng=rng)
