"""The benchmark's plain reference of SOC: a frozen copy, in plain PyTorch, of
the SOC forward (Video-Swin, RoBERTa, fusion, deformable transformer, VOC,
dynamic mask head), the criterion and Hungarian matcher, AdamW and the hash
tokenizer. It imports nothing of the program under test: the multi-scale
deformable attention and the window attention are the plain versions here,
and the engine's bucket padding, normalization, trajectory choice and resizes
(`engine.py`) and the train step (`train.py`) are worked out again.

Run it in float32 with TF32 off (`plain_float32`); `set_fp8` makes the control.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from .common import init_weights, set_fp8
from .criterion import CriterionConfig
from .matcher import MatchCosts
from .soc import SOC


def plain_float32() -> None:
    """Matmuls and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_reference(cfg: Mapping, dtype: torch.dtype = torch.float32,
                    device: Optional[torch.device] = None, fp8: bool = False) -> SOC:
    """The reference SOC of a configuration (the keys of configs/*.yaml,
    flattened), computed in `dtype`, with float8 operands when `fp8`. Its
    parameters are float32 and uninitialized: load the benchmark's weights."""
    dt, voc = cfg["DeformTransformer"], cfg["VOC"]
    model = SOC(
        backbone_name=cfg["backbone"], num_classes=cfg["num_classes"],
        d_model=dt["d_model"], num_queries=dt["num_queries"],
        num_feature_levels=dt["num_feature_levels"], nheads=dt["nheads"],
        enc_layers=dt["enc_layers"], dec_layers=dt["dec_layers"],
        dim_feedforward=dt["dim_feedforward"], dropout=dt.get("dropout", 0.1),
        enc_n_points=dt["enc_n_points"], dec_n_points=dt["dec_n_points"],
        with_box_refine=cfg["with_box_refine"], two_stage=dt.get("two_stage", False),
        two_stage_num_proposals=dt.get("two_stage_num_proposals", 300),
        rel_coord=cfg["rel_coord"], mask_kernels_dim=cfg["mask_kernels_dim"],
        controller_layers=cfg["controller_layers"],
        dynamic_mask_channels=cfg["dynamic_mask_channels"],
        voc_window_size=voc["window_size"], voc_enc_layers=voc["enc_layers"],
        voc_dec_layers=voc["dec_layers"], text_encoder_type=cfg["text_encoder_type"],
        freeze_text_encoder=cfg.get("freeze_text_encoder", True), vl_loss=cfg["vl_loss"],
        dtype=dtype)
    if device is not None:
        model = model.to(device)
    return set_fp8(model) if fp8 else model


def criterion_config(cfg: Mapping) -> CriterionConfig:
    costs = MatchCosts(cost_con=cfg["set_cost_con"], cost_cls=cfg["set_cost_cls"],
                       cost_dice=cfg["set_cost_dice"], cost_box=cfg["set_costs_box"],
                       cost_giou=cfg["set_costs_giou"], num_classes=cfg["num_classes"])
    return CriterionConfig(
        costs=costs, num_classes=cfg["num_classes"], eos_coef=cfg["eos_coef"],
        use_vl_loss=cfg["vl_loss"], aux_loss=cfg["aux_loss"],
        weight_con=cfg["con_loss_coef"], weight_cls=cfg["class_loss_coef"],
        weight_focal=cfg["sigmoid_focal_loss_coef"], weight_dice=cfg["dice_loss_coef"],
        weight_bbox=cfg["box_loss_coef"], weight_giou=cfg["giou_coef"])


__all__ = ["SOC", "build_reference", "criterion_config", "init_weights", "plain_float32",
           "set_fp8"]
