"""SetCriterion: losses over matched query/instance pairs (torch twin of
neurips2023_soc_tpu/losses/criterion.py).

Per decoder layer: Hungarian re-match, then mask (focal + dice), class (focal
on visibility-gated labels), box (L1 + GIoU) and the video-level
visual-linguistic contrastive loss. `num_masks` is the batch's count of
visible instance frames, a tensor on the device (no host read); on one card
it is already the global count.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from ..ops import resize_bilinear
from ..utils.boxes import box_cxcywh_to_xyxy, generalized_box_iou
from .matcher import MatchCosts, hungarian_match
from .segmentation import dice_loss, sigmoid_focal_loss


@dataclasses.dataclass(frozen=True)
class CriterionConfig:
    costs: MatchCosts = MatchCosts()
    num_classes: int = 1
    eos_coef: float = 0.1
    use_vl_loss: bool = True
    aux_loss: bool = True
    # loss weights (configs/refer_youtube_vos.yaml)
    weight_con: float = 1.0
    weight_cls: float = 2.0
    weight_focal: float = 2.0
    weight_dice: float = 5.0
    weight_bbox: float = 2.0
    weight_giou: float = 2.0


def _take_queries(x: torch.Tensor, assign: torch.Tensor) -> torch.Tensor:
    """x: (T, B, Nq, ...); assign: (B, N) -> (T, B, N, ...)."""
    idx = assign.clamp(min=0)
    T = x.shape[0]
    idx = idx[None].expand(T, *idx.shape)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 3)).expand(
        idx.shape + x.shape[3:])
    return torch.gather(x, 2, idx)


def _layer_losses(layer_out: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor],
                  cfg: CriterionConfig) -> Dict[str, torch.Tensor]:
    T, B, Nq, K = layer_out["pred_cls"].shape
    Ht, Wt = targets["masks"].shape[-2:]
    N = targets["inst_valid"].shape[1]
    valid = targets["inst_valid"].float()  # (B, N)

    # the matching cost needs every query's mask at full resolution, without
    # gradient; the loss upsamples only the matched queries (resize and
    # gather commute)
    with torch.no_grad():
        up_cost = resize_bilinear(layer_out["pred_masks"].detach().float()[..., None],
                                  Ht, Wt)[..., 0]  # (T, B, Nq, Ht, Wt)
    assign = hungarian_match(layer_out, targets, up_cost, cfg.costs)  # (B, N)
    del up_cost

    num_masks = (T * valid.sum()).clamp(min=1.0)
    losses = {}

    # masks
    src_small = _take_queries(layer_out["pred_masks"].float(), assign)
    src_masks = resize_bilinear(src_small[..., None], Ht, Wt)[..., 0]  # (T, B, N, Ht, Wt)
    tgt_masks = targets["masks"].float()
    w = valid[None].expand(T, B, N).reshape(-1)
    sm = src_masks.reshape(T * B * N, Ht * Wt)
    tm = tgt_masks.reshape(T * B * N, Ht * Wt)
    losses["loss_sigmoid_focal"] = sigmoid_focal_loss(sm, tm, num_masks, weight=w)
    losses["loss_dice"] = dice_loss(sm, tm, num_masks, weight=w)

    # boxes
    src_boxes = _take_queries(layer_out["pred_boxes"].float(), assign)
    tgt_boxes = targets["boxes"].float()
    l1 = (src_boxes - tgt_boxes).abs().sum(-1) * w.reshape(T, B, N)
    losses["loss_bbox"] = l1.sum() / num_masks
    pb = box_cxcywh_to_xyxy(src_boxes).reshape(-1, 1, 4)
    tb = box_cxcywh_to_xyxy(tgt_boxes).reshape(-1, 1, 4)
    giou = generalized_box_iou(pb, tb)[:, 0, 0]  # the matched pairs
    losses["loss_giou"] = ((1.0 - giou) * w).sum() / num_masks

    # class: the referred instance's matched query is the positive in every
    # frame where that instance is visible
    ref_idx = targets["referred_instance_idx"].long()  # (B,)
    q_ref = torch.gather(assign, 1, ref_idx[:, None])[:, 0]  # (B,)
    ref_valid = torch.gather(valid, 1, ref_idx[:, None])[:, 0]
    vis_ref = torch.gather(targets["is_ref_inst_visible"].float(), 2,
                           ref_idx[None, :, None].expand(T, B, 1))[..., 0]  # (T, B)
    if cfg.num_classes == 1:
        lbl = torch.zeros(B, dtype=torch.long, device=valid.device)
    else:
        lbl = torch.gather(targets["labels"].long(), 1, ref_idx[:, None])[:, 0]
    pred = layer_out["pred_cls"].float().transpose(0, 1).reshape(B, T * Nq, K)
    pos = (torch.arange(T, device=valid.device)[None, :] * Nq
           + q_ref.clamp(min=0)[:, None])  # (B, T)
    indicator = F.one_hot(pos, T * Nq).float()  # (B, T, T*Nq)
    gate = (vis_ref.t() * ref_valid[:, None])[..., None]  # (B, T, 1)
    indicator = (indicator * gate).sum(1)  # (B, T*Nq)
    onehot = indicator[..., None] * F.one_hot(lbl, K).float()[:, None, :]
    x = pred
    p = torch.sigmoid(x)
    ce = x.clamp(min=0) - x * onehot + torch.log1p(torch.exp(-x.abs()))
    p_t = p * onehot + (1 - p) * (1 - onehot)
    focal = (0.25 * onehot + 0.75 * (1 - onehot)) * ce * (1 - p_t) ** 2
    losses["loss_cls"] = focal.mean(1).sum() / num_masks * (T * Nq)

    # visual-linguistic contrastive
    if cfg.use_vl_loss:
        logit = layer_out["pred_logit"].float()  # (B, Nq, C)
        txt = layer_out["text_sentence_feature"].float()  # (B, C)
        sim = torch.einsum("bqc,bc->bq", logit / logit.shape[-1], txt)
        picked = torch.gather(torch.log_softmax(sim, -1), 1,
                              q_ref.clamp(min=0)[:, None])[:, 0]
        losses["loss_con"] = -(picked * ref_valid).mean()
    return losses


def compute_criterion(outputs: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor],
                      cfg: CriterionConfig) -> Dict[str, torch.Tensor]:
    """outputs: SOC's stacked-over-layers dict. Returns the flat loss dict,
    the last layer's under plain names and layer i's aux losses with `_i`."""
    Lyr = outputs["pred_masks"].shape[0]
    shared = {"text_sentence_feature": outputs["text_sentence_feature"]}

    def layer_slice(lvl):
        d = {k: outputs[k][lvl] for k in
             ("pred_masks", "pred_cls", "pred_boxes", "pred_logit")}
        d.update(shared)
        return d

    losses = dict(_layer_losses(layer_slice(Lyr - 1), targets, cfg))
    if cfg.aux_loss:
        for i in range(Lyr - 1):
            aux = _layer_losses(layer_slice(i), targets, cfg)
            losses.update({f"{k}_{i}": v for k, v in aux.items()})
    return losses


def total_loss(losses: Dict[str, torch.Tensor], cfg: CriterionConfig) -> torch.Tensor:
    base = {
        "loss_con": cfg.weight_con,
        "loss_cls": cfg.weight_cls,
        "loss_sigmoid_focal": cfg.weight_focal,
        "loss_dice": cfg.weight_dice,
        "loss_bbox": cfg.weight_bbox,
        "loss_giou": cfg.weight_giou,
    }
    tot = torch.zeros((), device=next(iter(losses.values())).device)
    for k, v in losses.items():
        root = k
        for suffix in range(10):
            if root.endswith(f"_{suffix}"):
                root = root[: -len(f"_{suffix}")]
        if root in base:
            tot = tot + base[root] * v
    return tot
