from typing import Optional, Union

import torch

from ..device import resolve_device
from .common import init_weights
from .deformable_transformer import DeformableTransformer
from .segmentation import FPNSpatialDecoder, dynamic_mask_with_coords
from .soc import SOC
from .text_encoder import ROBERTA_CONFIGS, RobertaEncoder, build_tokenizer
from .video_swin import SWIN_CONFIGS, VideoSwinBackbone, build_video_swin
from .voc import VOC


def build_model(config, device: Optional[Union[str, torch.device]] = None,
                seed: int = 0) -> SOC:
    """SOC from a loaded config (config.load_config), initialized from a
    seeded torch.Generator and placed on `device` — the CUDA card when None
    (RuntimeError without CUDA). Parameters are float32; compute runs in
    `compute_dtype`."""
    dev = resolve_device(device)
    dt = config.DeformTransformer
    voc = config.VOC
    dtype = (torch.bfloat16 if config.get("compute_dtype", "float32") == "bfloat16"
             else torch.float32)
    model = SOC(
        backbone_name=config.backbone,
        num_classes=config.num_classes,
        d_model=dt["d_model"],
        num_queries=dt["num_queries"],
        num_feature_levels=dt["num_feature_levels"],
        nheads=dt["nheads"],
        enc_layers=dt["enc_layers"],
        dec_layers=dt["dec_layers"],
        dim_feedforward=dt["dim_feedforward"],
        dropout=dt.get("dropout", 0.1),
        enc_n_points=dt["enc_n_points"],
        dec_n_points=dt["dec_n_points"],
        with_box_refine=config.with_box_refine,
        two_stage=dt.get("two_stage", False),
        two_stage_num_proposals=dt.get("two_stage_num_proposals", 300),
        rel_coord=config.rel_coord,
        mask_kernels_dim=config.mask_kernels_dim,
        controller_layers=config.controller_layers,
        dynamic_mask_channels=config.dynamic_mask_channels,
        voc_window_size=voc["window_size"],
        voc_enc_layers=voc["enc_layers"],
        voc_dec_layers=voc["dec_layers"],
        text_encoder_type=config.text_encoder_type,
        freeze_text_encoder=config.get("freeze_text_encoder", True),
        vl_loss=config.vl_loss,
        use_remat=config.get("use_checkpoint", False),
        dtype=dtype,
    )
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


__all__ = [
    "SOC",
    "build_model",
    "DeformableTransformer",
    "FPNSpatialDecoder",
    "dynamic_mask_with_coords",
    "RobertaEncoder",
    "ROBERTA_CONFIGS",
    "build_tokenizer",
    "SWIN_CONFIGS",
    "VideoSwinBackbone",
    "build_video_swin",
    "VOC",
]
