"""JAX parameter tree -> this package's state_dict.

The port's modules carry the reference SOC's state_dict key names and layouts,
so a parameter tree of the JAX package (nested dicts of numpy arrays, as
`jax.tree_util.tree_map(np.asarray, params)` gives) converts key for key and
loads with `strict=True`. The mapping below is the port's own copy of
neurips2023_soc_tpu/training/convert.py:flax_to_torch, extended with the
two-stage encoder heads, which the reference lacks, and with the ResNet-50
backbone, which the JAX converter does not map.

Layout transforms (flax -> torch):
  linear : (in, out)              -> (out, in)
  conv   : (kh, kw, in, out)      -> (out, in, kh, kw)
  conv3d : (kd, kh, kw, in, out)  -> (out, in, kd, kh, kw)
  copy   : identical (biases, tables, embeddings, norms)
"""
from __future__ import annotations

import math
import re
import zlib
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _t(x):
    return np.ascontiguousarray(np.transpose(x))


INVERSE_TRANSFORMS = {
    "linear": _t,
    "conv": lambda x: np.ascontiguousarray(np.transpose(x, (3, 2, 0, 1))),
    "conv3d": lambda x: np.ascontiguousarray(np.transpose(x, (4, 3, 0, 1, 2))),
    "copy": lambda x: np.asarray(x),
}


_FROZEN_BN_LEAVES = {"frozen_bn_scale": "weight", "frozen_bn_bias": "bias",
                     "frozen_bn_mean": "running_mean", "frozen_bn_var": "running_var"}


def flax_to_torch(path: Tuple[str, ...]) -> Optional[Tuple[str, str]]:
    """Map a flax param path (under 'params') to (torch_key, transform kind).

    Returns None when the parameter has no torch counterpart.
    """
    p = "/".join(path)
    leaf = path[-1]

    def lin(torch_prefix):
        if leaf == "kernel":
            return torch_prefix + ".weight", "linear"
        return torch_prefix + ".bias", "copy"

    def norm(torch_prefix):
        if leaf == "scale":
            return torch_prefix + ".weight", "copy"
        return torch_prefix + ".bias", "copy"

    def mha(torch_prefix):
        if leaf == "in_proj_kernel":
            return torch_prefix + ".in_proj_weight", "linear"
        if leaf == "in_proj_bias":
            return torch_prefix + ".in_proj_bias", "copy"
        return None

    # ---------------- backbone: video swin ----------------
    m = re.match(r"backbone/(.*)", p)
    if m:
        rest = m.group(1)
        bb = "backbone.0.body."
        if rest.startswith("patch_embed/"):
            if leaf == "kernel":
                return bb + "patch_embed.proj.weight", "conv3d"
            return bb + "patch_embed.proj.bias", "copy"
        if rest.startswith("patch_norm/"):
            return norm(bb + "patch_embed.norm")
        m2 = re.match(r"layers_(\d+)_blocks_(\d+)/(.*)", rest)
        if m2:
            s, i, sub = m2.groups()
            tp = f"{bb}layers.{s}.blocks.{i}."
            if sub.startswith("norm1/"):
                return norm(tp + "norm1")
            if sub.startswith("norm2/"):
                return norm(tp + "norm2")
            if sub.startswith("attn/qkv/"):
                return lin(tp + "attn.qkv")
            if sub.startswith("attn/proj/"):
                return lin(tp + "attn.proj")
            if sub == "attn/relative_position_bias_table":
                return tp + "attn.relative_position_bias_table", "copy"
            if sub.startswith("mlp_fc1/"):
                return lin(tp + "mlp.fc1")
            if sub.startswith("mlp_fc2/"):
                return lin(tp + "mlp.fc2")
        m2 = re.match(r"layers_(\d+)_downsample/(.*)", rest)
        if m2:
            s, sub = m2.groups()
            tp = f"{bb}downsamples.{s}."
            if sub.startswith("norm/"):
                return norm(tp + "norm")
            if sub.startswith("reduction/"):
                return lin(tp + "reduction")
        # 2D Swin per-stage output norms (reference swin_transformer.py:527,
        # 611-615: self.norm{i} applied to each out level)
        m2 = re.match(r"out_norm_(\d+)/", rest)
        if m2:
            return norm(f"{bb}norm{m2.group(1)}")
        # ResNet-50 (models/resnet.py), torchvision's keys: layer{s}_{i} ->
        # layer{s}.{i}, downsample_{conv,bn} -> downsample.{0,1}, HWIO kernels
        # -> OIHW, FrozenBN scale/bias/mean/var -> weight/bias/running_*
        m2 = re.match(r"(?:layer(\d)_(\d+)/)?(conv\d|bn\d|downsample_conv|downsample_bn)/$",
                      rest[:-len(leaf)])
        if m2:
            s, i, mod = m2.groups()
            tp = bb + (f"layer{s}.{i}." if s else "")
            mod = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(mod, mod)
            if leaf == "kernel":
                return f"{tp}{mod}.weight", "conv"
            if leaf in _FROZEN_BN_LEAVES:
                return f"{tp}{mod}.{_FROZEN_BN_LEAVES[leaf]}", "copy"
        return None

    # ---------------- text encoder: roberta ----------------
    m = re.match(r"text_encoder/(.*)", p)
    if m:
        rest = m.group(1)
        te = "text_encoder."
        emb = te + "embeddings."
        if rest.startswith("word_embeddings/"):
            return emb + "word_embeddings.weight", "copy"
        if rest.startswith("position_embeddings/"):
            return emb + "position_embeddings.weight", "copy"
        if rest.startswith("token_type_embeddings/"):
            return emb + "token_type_embeddings.weight", "copy"
        if rest.startswith("emb_ln/"):
            return norm(emb + "LayerNorm")
        m2 = re.match(r"layer_(\d+)_(q|k|v|attn_out|attn_ln|inter|out|out_ln)/(.*)", rest)
        if m2:
            i, part, _ = m2.groups()
            tp = te + f"encoder.layer.{i}."
            table = {
                "q": (lin, tp + "attention.self.query"),
                "k": (lin, tp + "attention.self.key"),
                "v": (lin, tp + "attention.self.value"),
                "attn_out": (lin, tp + "attention.output.dense"),
                "attn_ln": (norm, tp + "attention.output.LayerNorm"),
                "inter": (lin, tp + "intermediate.dense"),
                "out": (lin, tp + "output.dense"),
                "out_ln": (norm, tp + "output.LayerNorm"),
            }
            fn, key = table[part]
            return fn(key)
        if rest.startswith("pooler/"):
            return lin(te + "pooler.dense")
        return None

    # ---------------- deformable transformer ----------------
    m = re.match(r"transformer/(.*)", p)
    if m:
        rest = m.group(1)
        tf = "transformer."
        if rest == "level_embed":
            return tf + "level_embed", "copy"
        if rest.startswith("reference_points/"):
            return lin(tf + "reference_points")
        # two-stage submodules (reference deformable_transformer.py:55-58).
        # enc_class_embed/enc_bbox_embed have no reference counterpart (the
        # reference's two-stage head sharing is broken as shipped); they map
        # to keys of their own so a two-stage model also loads strictly.
        if rest.startswith("enc_output/"):
            return lin(tf + "enc_output")
        if rest.startswith("enc_output_norm/"):
            return norm(tf + "enc_output_norm")
        if rest.startswith("pos_trans/"):
            return lin(tf + "pos_trans")
        if rest.startswith("pos_trans_norm/"):
            return norm(tf + "pos_trans_norm")
        if rest.startswith("enc_class_embed/"):
            return lin(tf + "enc_class_embed")
        m2 = re.match(r"enc_bbox_embed/layers_(\d+)/", rest)
        if m2:
            return lin(tf + f"enc_bbox_embed.layers.{m2.group(1)}")
        m2 = re.match(r"encoder_layers_(\d+)/(.*)", rest)
        if m2:
            i, sub = m2.groups()
            tp = tf + f"encoder.layers.{i}."
            if sub.startswith("self_attn/"):
                part = sub.split("/")[1]
                return lin(tp + f"self_attn.{part}")
            if sub.startswith("norm1/"):
                return norm(tp + "norm1")
            if sub.startswith("ffn/linear1/"):
                return lin(tp + "linear1")
            if sub.startswith("ffn/linear2/"):
                return lin(tp + "linear2")
            if sub.startswith("ffn/norm/"):
                return norm(tp + "norm2")
        m2 = re.match(r"decoder_layers_(\d+)/(.*)", rest)
        if m2:
            i, sub = m2.groups()
            tp = tf + f"decoder.layers.{i}."
            if sub.startswith("cross_attn/"):
                part = sub.split("/")[1]
                return lin(tp + f"cross_attn.{part}")
            if sub.startswith("self_attn/"):
                r = mha(tp + "self_attn")
                if r:
                    return r
                if sub.startswith("self_attn/out_proj/"):
                    return lin(tp + "self_attn.out_proj")
            if sub.startswith("norm1/"):
                return norm(tp + "norm1")
            if sub.startswith("norm2/"):
                return norm(tp + "norm2")
            if sub.startswith("ffn/linear1/"):
                return lin(tp + "linear1")
            if sub.startswith("ffn/linear2/"):
                return lin(tp + "linear2")
            if sub.startswith("ffn/norm/"):
                return norm(tp + "norm3")
        m2 = re.match(r"bbox_embed_(\d+)/layers_(\d+)/(.*)", rest)
        if m2:
            l, j, _ = m2.groups()
            return lin(f"bbox_embed.{l}.layers.{j}")
        return None

    # ---------------- VOC ----------------
    m = re.match(r"voc/(.*)", p)
    if m:
        rest = m.group(1)
        if rest == "fq_pos":
            return "voc.fq_pos.weight", "copy"
        if rest == "query_embed":
            return "voc.query_embed.weight", "copy"
        if rest.startswith("decoder_norm/"):
            return norm("voc.decoder_norm")
        specs = [
            (r"enc_self_attn_(\d+)/self_attn/(.*)", "voc.enc_self_attn.{}.self_attn"),
            (r"dec_self_(\d+)/self_attn/(.*)",
             "voc.transformer_self_attention_layers.{}.self_attn"),
            (r"dec_cross_(\d+)/multihead_attn/(.*)",
             "voc.transformer_cross_attention_layers.{}.multihead_attn"),
        ]
        for pat, fmt in specs:
            m2 = re.match(pat, rest)
            if m2:
                i, sub = m2.groups()
                tp = fmt.format(i)
                r = mha(tp)
                if r:
                    return r
                if sub.startswith("out_proj/"):
                    return lin(tp + ".out_proj")
        norms = [
            (r"enc_self_attn_(\d+)/norm/", "voc.enc_self_attn.{}.norm"),
            (r"dec_self_(\d+)/norm/", "voc.transformer_self_attention_layers.{}.norm"),
            (r"dec_cross_(\d+)/norm/", "voc.transformer_cross_attention_layers.{}.norm"),
            (r"enc_ffn_(\d+)/norm/", "voc.enc_ffn.{}.norm"),
            (r"dec_ffn_(\d+)/norm/", "voc.transformer_ffn_layers.{}.norm"),
        ]
        for pat, fmt in norms:
            m2 = re.match(pat, rest)
            if m2:
                return norm(fmt.format(m2.group(1)))
        ffns = [
            (r"enc_ffn_(\d+)/linear(\d)/", "voc.enc_ffn.{}.linear{}"),
            (r"dec_ffn_(\d+)/linear(\d)/", "voc.transformer_ffn_layers.{}.linear{}"),
        ]
        for pat, fmt in ffns:
            m2 = re.match(pat, rest)
            if m2:
                return lin(fmt.format(*m2.groups()))
        return None

    # ---------------- SOC top level ----------------
    if p == "query_embed":
        return "query_embed.weight", "copy"
    m = re.match(r"class_embed_(\d+)/(.*)", p)
    if m:
        return lin(f"class_embed.{m.group(1)}")
    m = re.match(r"controller/layers_(\d+)/(.*)", p)
    if m:
        return lin(f"controller.layers.{m.group(1)}")
    m = re.match(r"input_proj_(\d+)_conv/(.*)", p)
    if m:
        if leaf == "kernel":
            return f"input_proj.{m.group(1)}.0.weight", "conv"
        return f"input_proj.{m.group(1)}.0.bias", "copy"
    m = re.match(r"input_proj_(\d+)_gn/(.*)", p)
    if m:
        return norm(f"input_proj.{m.group(1)}.1")
    m = re.match(r"(vlf|lvf)/multihead_attn/(.*)", p)
    if m:
        which, sub = m.groups()
        tp = f"{which}.multihead_attn"
        r = mha(tp)
        if r:
            return r
        if sub.startswith("out_proj/"):
            return lin(tp + ".out_proj")
    m = re.match(r"txt_proj/(fc|layer_norm)/(.*)", p)
    if m:
        if m.group(1) == "fc":
            return lin("txt_proj.fc")
        return norm("txt_proj.layer_norm")
    m = re.match(r"spatial_decoder/(.*)", p)
    if m:
        rest = m.group(1)
        sd = "spatial_decoder."
        m2 = re.match(r"(lay\d|adapter\d|out_lay)/(.*)", rest)
        if m2:
            name = m2.group(1)
            if leaf == "kernel":
                return sd + name + ".weight", "conv"
            return sd + name + ".bias", "copy"
        m2 = re.match(r"(gn\d)/(.*)", rest)
        if m2:
            return norm(sd + m2.group(1))
    return None


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, Mapping):
            yield from _leaves(v, path)
        else:
            yield path, v


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX parameter tree (nested dicts of arrays, with or without the
    top-level 'params' collection) -> numpy state_dict with the reference's
    key names and layouts. Raises on a parameter with no mapping."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    sd: Dict[str, np.ndarray] = {}
    for path, leaf in _leaves(params):
        mapped = flax_to_torch(path)
        if mapped is None:
            raise KeyError(f"no torch key for JAX parameter {'/'.join(path)}")
        key, kind = mapped
        sd[key] = INVERSE_TRANSFORMS[kind](np.asarray(leaf, np.float32))
    return sd


def load_jax_params(model: torch.nn.Module, params: Mapping[str, Any]) -> torch.nn.Module:
    """Copy a JAX parameter tree into `model` (strict: every key on both
    sides must match)."""
    sd = {k: torch.tensor(v) for k, v in state_dict_from_jax(params).items()}
    model.load_state_dict(sd, strict=True)
    return model


def kinetics_swin_to_backbone(state_dict: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A Kinetics-400 Video-Swin torch checkpoint as SOC backbone keys
    (reference video_swin_transformer.py:646-670; the port's copy of the JAX
    package's converter): the 'backbone.' prefix stripped, the patch embed's
    temporal kernel summed (2, 4, 4) -> (1, 4, 4), and each stage's
    downsample moved out of its BasicLayer (layers.{s}.downsample ->
    downsamples.{s}). The result loads with `load_state_dict(strict=False)`:
    the port's modules carry the reference's key names."""
    out = {}
    for k, v in state_dict.items():
        if not k.startswith("backbone."):
            continue
        k = k[len("backbone."):]
        if "relative_position_index" in k or "attn_mask" in k:
            continue
        if k == "patch_embed.proj.weight":
            v = np.asarray(v).sum(axis=2, keepdims=True)
        m = re.match(r"layers\.(\d+)\.downsample\.(.*)", k)
        if m:
            k = f"downsamples.{m.group(1)}.{m.group(2)}"
        out["backbone.0.body." + k] = np.asarray(v)
    return out


def swin2d_to_backbone(state_dict: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """An ImageNet 2D-Swin torch checkpoint (the official layout, e.g. the
    'model' dict of swin_{tiny,small,base,large}_patch4_window7_224.pth) as
    backbone keys of the swin-* 2D configs: a singleton temporal axis in the
    patch embed, (C, 3, 4, 4) -> (C, 3, 1, 4, 4) (the 2D bias table already
    matches the (1, 7, 7)-window table), the classifier head and final norm
    dropped, and the downsamples moved as in kinetics_swin_to_backbone."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("backbone."):
            k = k[len("backbone."):]
        if ("relative_position_index" in k or "attn_mask" in k or k.startswith("head.")
                or k in ("norm.weight", "norm.bias")):
            continue
        v = np.asarray(v)
        if k == "patch_embed.proj.weight":
            v = v[:, :, None]
        m = re.match(r"layers\.(\d+)\.downsample\.(.*)", k)
        if m:
            k = f"downsamples.{m.group(1)}.{m.group(2)}"
        out["backbone.0.body." + k] = v
    return out


# ---------------------------------------------------------------- seeded weights
# Random weights that two frameworks (and two versions of torch) rebuild
# identically: every parameter is drawn from numpy's legacy RandomState
# stream, whose values numpy keeps fixed across releases, seeded from the
# model seed and the CRC-32 of the parameter's key, so any one key can be made
# without the others. A rule string names the distribution:
#   normal:<std>     N(0, std^2)           weights (std 1/sqrt(fan_in)), tables
#   norm             1 + 0.1 N(0, 1)       norm scales, FrozenBN variances
#   bias             0.02 N(0, 1)          biases, FrozenBN means
#   grid:<M>,<L>,<P> the MSDA sampling-offset direction grid (M heads, L
#                    levels, P points; models.deformable_transformer)
# The MSDA `sampling_offsets` weight is normal:0.05 over its grid bias: the
# samples leave the pixel centres where the init's zero weight puts them (the
# bilinear kinks), and some leave the map, so the zero-pad corners run too.
# The Swin relative-position tables are normal:1.5, a trained table's spread.

def _grid_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Direction-grid bias of the sampling offsets (the port's init,
    reference models/ops/modules/ms_deform_attn.py:63-71), in float64 and
    rounded to 1e-6: float32 cos and sin differ in their last bit between
    numpy builds, the rounded directions do not."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = np.round(grid / np.abs(grid).max(-1, keepdims=True), 6)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


def param_rules(model: torch.nn.Module) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """{state_dict key: (shape, rule)} for every tensor of `model`'s
    state_dict, the rule chosen by the module that holds it (see above);
    raises on a tensor no rule covers."""
    mods = dict(model.named_modules())
    rules = {}
    for key, t in model.state_dict().items():
        owner, _, leaf = key.rpartition(".")
        mod = mods[owner]
        parent = mods.get(owner.rpartition(".")[0])
        kind = type(mod).__name__
        shape = tuple(t.shape)
        if (owner.endswith("sampling_offsets") and parent is not None
                and hasattr(parent, "n_points")):
            rule = ("normal:0.05" if leaf == "weight" else
                    f"grid:{parent.n_heads},{parent.n_levels},{parent.n_points}")
        elif leaf == "relative_position_bias_table":
            rule = "normal:1.5"
        elif leaf == "level_embed":
            rule = "normal:1.0"
        elif kind == "Embedding":
            rule = f"normal:{float(mod.std)!r}"
        elif kind in ("LayerNorm", "GroupNorm", "FrozenBN") and leaf in ("weight", "running_var"):
            rule = "norm"
        elif leaf in ("bias", "in_proj_bias", "running_mean"):
            rule = "bias"
        elif leaf in ("weight", "in_proj_weight") and len(shape) >= 2:
            rule = f"normal:{math.prod(shape[1:]) ** -0.5!r}"
        else:
            raise KeyError(f"no seeded-weight rule for {key} ({kind}, {shape})")
        rules[key] = (shape, rule)
    return rules


def seeded_array(key: str, shape: Tuple[int, ...], rule: str, seed: int) -> np.ndarray:
    """One parameter, float32, from RandomState([seed, crc32(key)])."""
    if rule.startswith("grid:"):
        out = _grid_bias(*(int(v) for v in rule[5:].split(",")))
        if out.shape != tuple(shape):
            raise ValueError(f"{key}: grid {out.shape} for shape {shape}")
        return out
    rng = np.random.RandomState([seed, zlib.crc32(key.encode())])
    z = rng.standard_normal(shape)
    if rule == "norm":
        z = 1.0 + 0.1 * z
    elif rule == "bias":
        z = 0.02 * z
    elif rule.startswith("normal:"):
        z = float(rule[7:]) * z
    else:
        raise ValueError(f"unknown rule {rule!r} for {key}")
    return z.astype(np.float32)


def seeded_state_dict(model: torch.nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """numpy state_dict of `model` from `seed`, the same bytes on any
    machine; loads with strict=True."""
    return {k: seeded_array(k, shape, rule, seed)
            for k, (shape, rule) in param_rules(model).items()}


def weights_fingerprint(sd: Mapping[str, Any]) -> Dict[str, list]:
    """{key: [sum, sum of squares, first 4 values]} in float64 per tensor
    (numpy or torch), to tell different weights from a fault downstream."""
    out = {}
    for k in sorted(sd):
        v = sd[k]
        a = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
        a = a.astype(np.float64).reshape(-1)
        out[k] = [float(a.sum()), float(np.square(a).sum())] + [float(x) for x in a[:4]]
    return out
