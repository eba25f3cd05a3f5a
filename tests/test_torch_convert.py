"""The port's weight seam: convert.state_dict_from_jax against the JAX
package's export_torch_state_dict, strict loading into the port's SOC built
from the same config, and the entry points' device default."""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from neurips2023_soc_tpu.config import load_config as jax_load_config
from neurips2023_soc_tpu.models import build_model as jax_build_model
from neurips2023_soc_tpu.training.convert import export_torch_state_dict
from neurips2023_soc_torch.config import load_config
from neurips2023_soc_torch.convert import flax_to_torch, load_jax_params, state_dict_from_jax
from neurips2023_soc_torch.inference import InferenceEngine
from neurips2023_soc_torch.models import build_model
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "tiny_synthetic.yaml"


def _random_jax_params(overrides=None):
    """The JAX model's parameter tree (shapes from jax.eval_shape: no
    compile), filled with seeded random values."""
    jm = jax_build_model(jax_load_config(CONFIG, overrides))
    px = np.zeros((2, 1, 32, 32, 3), np.float32)
    pad = np.zeros((2, 1, 32, 32), bool)
    ids = np.ones((1, 4), np.int32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), px, pad, ids, ids)
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)


@pytest.fixture(scope="module")
def params():
    return _random_jax_params()


def test_state_dict_equals_jax_export(params):
    ours = state_dict_from_jax(params)
    theirs = export_torch_state_dict(params)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert ours[k].shape == v.shape, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_strict_load_into_model_from_the_same_config(params):
    model = build_model(load_config(CONFIG), device="cpu")
    load_jax_params(model, params)  # strict: raises on any missing/unexpected key
    sd = state_dict_from_jax(params)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_two_stage_keys_cover_the_model():
    """Two-stage adds the encoder-stage heads, which the reference lacks; the
    port's mapping gives them keys of their own so the load stays strict."""
    overrides = {"DeformTransformer": dict(
        load_config(CONFIG).DeformTransformer, two_stage=True, two_stage_num_proposals=8)}
    params = _random_jax_params(overrides)
    model = build_model(load_config(CONFIG, overrides), device="cpu")
    load_jax_params(model, params)
    extra = set(state_dict_from_jax(params)) - set(export_torch_state_dict(params))
    assert extra and all(k.startswith(("transformer.enc_class_embed.",
                                       "transformer.enc_bbox_embed.")) for k in extra)
    assert flax_to_torch(("transformer", "enc_bbox_embed", "layers_2", "kernel")) == (
        "transformer.enc_bbox_embed.layers.2.weight", "linear")


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(CONFIG)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(model, text_encoder_type="roberta-tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg, device="cuda")
