"""The model's weights, made on the device from the seed in one large draw.

The rules follow the reference SOC's modules (the same keys as the program's
state_dict): weights N(0, 1/fan_in), norm scales 1 + 0.1 N, biases 0.02 N,
embeddings N(0, std of the module), the Swin relative-position tables 1.5 N
(a trained table's spread), the level embedding N(0, 1), and the MSDA
sampling offsets 0.05 N over their direction-grid bias, so the samples leave
the pixel centres and some leave the map. The program and the reference load
the same tensors.

One departure from those rules, so that masks follow the features: the mask
head's dynamic convolution takes the query's offset to each pixel in pixels
(up to hundreds), so with weights of the features' size its logits are a
half-plane in the coordinates, of a scale in the thousands, whose edge often
misses the frame (every mask empty or full, whatever the precision). The
controller rows that make the first dynamic layer's two coordinate weights
are scaled by 1/64, as if the offsets were measured in 64-pixel units
(CondInst's normalization), so the features and the offset weigh alike; and
the row that makes the last layer's bias is scaled alike, so a query's mask
is not pushed empty or full as a whole.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from .reference import build_reference


def grid_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """The direction grid of the sampling offsets: head h points at angle
    2 pi h / M, point i at distance i + 1."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = np.round(grid / np.abs(grid).max(-1, keepdims=True), 6)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


def weight_rules(model: torch.nn.Module) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """{state_dict key: (shape, rule)}; rules: normal:<std>, norm, bias,
    grid:<M>,<L>,<P>."""
    mods = dict(model.named_modules())
    rules = {}
    for key, t in model.state_dict().items():
        owner, _, leaf = key.rpartition(".")
        mod = mods[owner]
        parent = mods.get(owner.rpartition(".")[0])
        kind = type(mod).__name__
        shape = tuple(t.shape)
        if owner.endswith("sampling_offsets") and hasattr(parent, "n_points"):
            rule = ("normal:0.05" if leaf == "weight" else
                    f"grid:{parent.n_heads},{parent.n_levels},{parent.n_points}")
        elif leaf == "relative_position_bias_table":
            rule = "normal:1.5"
        elif leaf == "level_embed":
            rule = "normal:1.0"
        elif kind == "Embedding":
            rule = f"normal:{float(mod.std)!r}"
        elif kind in ("LayerNorm", "GroupNorm") and leaf == "weight":
            rule = "norm"
        elif leaf in ("bias", "in_proj_bias"):
            rule = "bias"
        elif leaf in ("weight", "in_proj_weight") and len(shape) >= 2:
            rule = f"normal:{math.prod(shape[1:]) ** -0.5!r}"
        else:
            raise KeyError(f"no weight rule for {key} ({kind}, {shape})")
        rules[key] = (shape, rule)
    return rules


COORD_SCALE = 1.0 / 64


def coordinate_rows(cfg) -> list:
    """Rows of the controller's last layer that generate the first dynamic
    layer's weights on the two relative coordinates (layout (out, in),
    inputs: the mask features, then x and y), and the last layer's bias (the
    parameters: every layer's weights, then every layer's biases)."""
    Cm, ch, n = cfg["mask_kernels_dim"], cfg["dynamic_mask_channels"], cfg["controller_layers"]
    cin = Cm + 2 if cfg.get("rel_coord", True) else Cm
    weights = [cin * ch] + [ch * ch] * (n - 2) + [ch]
    biases = [ch] * (n - 1) + [1]
    rows = [o * cin + Cm + j for o in range(ch) for j in (0, 1)] if cin > Cm else []
    return rows + [sum(weights) + sum(biases) - 1]


def make_weights(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 tensors on `device` for every key of the configuration's SOC."""
    with torch.device("meta"):
        rules = weight_rules(build_reference(cfg))
    drawn = [k for k, (_, r) in rules.items() if not r.startswith("grid:")]
    total = sum(math.prod(rules[k][0]) for k in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for key, (shape, rule) in rules.items():
        if rule.startswith("grid:"):
            out[key] = torch.from_numpy(
                grid_bias(*(int(v) for v in rule[5:].split(",")))).to(device).view(shape)
            continue
        n = math.prod(shape)
        v = z[at:at + n].view(shape)
        at += n
        if rule == "norm":
            out[key] = 1.0 + 0.1 * v
        elif rule == "bias":
            out[key] = 0.02 * v
        else:
            out[key] = float(rule[7:]) * v
    last = f"controller.layers.{cfg['controller_layers'] - 1}"
    rows = torch.tensor(coordinate_rows(cfg), dtype=torch.long, device=device)
    for leaf in ("weight", "bias"):
        out[f"{last}.{leaf}"][rows] *= COORD_SCALE
    return out
