"""Config loading: YAML files of ``{key: {desc, value}}`` flattened to one
attribute namespace (the port's copy of neurips2023_soc_tpu/config.py's
loader), so the repo's configs/*.yaml drive the port unchanged.

Usage:
    cfg = load_config("configs/refer_youtube_vos.yaml", overrides={"backbone": "video-swin-b"})
    cfg.backbone, cfg.DeformTransformer["d_model"], ...
"""
from __future__ import annotations

import argparse
import copy
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import yaml


class Config:
    """Attribute-style view over a plain dict (nested dicts stay dicts)."""

    def __init__(self, data: Dict[str, Any]):
        object.__setattr__(self, "_data", dict(data))

    def __getattr__(self, k: str) -> Any:
        try:
            return self._data[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k: str, v: Any) -> None:
        self._data[k] = v

    def __contains__(self, k: str) -> bool:
        return k in self._data

    def get(self, k: str, default: Any = None) -> Any:
        return self._data.get(k, default)

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._data)

    def replace(self, **kwargs: Any) -> "Config":
        d = self.to_dict()
        d.update(kwargs)
        return Config(d)

    def __repr__(self) -> str:
        return f"Config({self._data!r})"


def _flatten_yaml(raw: Mapping[str, Any]) -> Dict[str, Any]:
    """{key: {desc, value}} -> {key: value}; bare values pass through."""
    return {k: (v["value"] if isinstance(v, Mapping) and "value" in v else v)
            for k, v in raw.items()}


# keys of the reference's own YAMLs whose role is carried by another key here;
# applied only when the target key is absent
_REFERENCE_ALIASES = (
    ("enable_amp", "compute_dtype", lambda v: "bfloat16" if v else "float32"),
    ("davis_path", "img_folder", None),
    ("out_dir", "output_dir", None),
)


def load_config(path: str | Path,
                overrides: Optional[Mapping[str, Any]] = None) -> Config:
    with open(path) as f:
        raw = yaml.safe_load(f)
    data = _flatten_yaml(raw or {})
    for ref_key, our_key, conv in _REFERENCE_ALIASES:
        if ref_key in data and our_key not in data:
            v = data[ref_key]
            data[our_key] = conv(v) if conv else v
    for k, v in (overrides or {}).items():
        if v is not None:
            data[k] = v
    return Config(data)


def add_config_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The config flags of the port's inference CLI, named as in the JAX
    package (reference main.py:61-97); each given flag overrides the config
    key of its name. The training and pretrained-weight flags come with the
    CLIs that read them, so an unknown flag is refused, not ignored."""
    parser.add_argument("--config_path", "-c", required=True)
    parser.add_argument("--backbone", "-b", default=None)
    parser.add_argument("--checkpoint_path", "-ckpt", default=None)
    parser.add_argument("--output_dir", default=None)
    return parser


def config_from_args(args: argparse.Namespace) -> Config:
    overrides = {k: v for k, v in vars(args).items() if k != "config_path"}
    return load_config(args.config_path, overrides=overrides)
