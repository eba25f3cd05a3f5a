from .criterion import CriterionConfig, compute_criterion, total_loss
from .matcher import MatchCosts, compute_cost_matrix, hungarian_match, lsa_on_device
from .segmentation import dice_loss, sigmoid_focal_loss


def build_criterion_config(config) -> CriterionConfig:
    """Criterion and matcher weights from a loaded config."""
    costs = MatchCosts(
        cost_con=config.set_cost_con,
        cost_cls=config.set_cost_cls,
        cost_dice=config.set_cost_dice,
        cost_box=config.set_costs_box,
        cost_giou=config.set_costs_giou,
        num_classes=config.num_classes,
    )
    return CriterionConfig(
        costs=costs,
        num_classes=config.num_classes,
        eos_coef=config.eos_coef,
        use_vl_loss=config.vl_loss,
        aux_loss=config.aux_loss,
        weight_con=config.con_loss_coef,
        weight_cls=config.class_loss_coef,
        weight_focal=config.sigmoid_focal_loss_coef,
        weight_dice=config.dice_loss_coef,
        weight_bbox=config.box_loss_coef,
        weight_giou=config.giou_coef,
    )


__all__ = [
    "CriterionConfig",
    "MatchCosts",
    "build_criterion_config",
    "compute_cost_matrix",
    "compute_criterion",
    "dice_loss",
    "hungarian_match",
    "lsa_on_device",
    "sigmoid_focal_loss",
    "total_loss",
]
