"""The whole SOC of the port against the JAX package's, on the CPU in float32
at the tiny shape of tests/test_inference.py (video-swin-t, d_model 64,
roberta-tiny), batch 2 with padding: the JAX model is initialized, its
parameters converted (convert.load_jax_params, strict) and every output
compared at rtol = atol = 1e-4. The port's SOC with `swin_attn_impl:
pallas` (K3's plain version on the CPU) is held against the same JAX model,
which keeps the default `xla` (its Pallas kernel does not run on the CPU
outside interpret mode)."""
import jax
import numpy as np
import pytest
import torch

from neurips2023_soc_tpu.models.soc import SOC as JaxSOC
from neurips2023_soc_torch.convert import load_jax_params
from neurips2023_soc_torch.models.soc import SOC
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)

KW = dict(backbone_name="video-swin-t", d_model=64, num_queries=5, dim_feedforward=128,
          enc_layers=1, dec_layers=2, voc_enc_layers=1, voc_dec_layers=1,
          text_encoder_type="roberta-tiny")
KEYS = ("pred_masks", "pred_cls", "pred_boxes", "pred_logit", "text_sentence_feature")


def _inputs():
    rng = np.random.RandomState(0)
    T, B, H, W = 4, 2, 48, 64
    px = rng.randn(T, B, H, W, 3).astype(np.float32)
    pad = np.zeros((T, B, H, W), bool)
    pad[:, 1, 40:] = True  # sample 1 is 40 x 56 content in the 48 x 64 bucket
    pad[:, 1, :, 56:] = True
    px[pad] = 0.0
    ids = rng.randint(3, 1000, size=(B, 8)).astype(np.int32)
    msk = np.ones((B, 8), np.int32)
    msk[1, 5:] = 0
    return px, pad, ids, msk


@pytest.fixture(scope="module")
def models():
    inputs = _inputs()
    jm = JaxSOC(dropout=0.0, **KW)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), *inputs))
    tm = load_jax_params(SOC(**KW), params).eval()
    return jm, params, tm, inputs


@pytest.fixture(scope="module")
def jax_forward(models):
    jm, params, _, inputs = models
    return jax.tree_util.tree_map(np.asarray, jax.jit(jm.apply)(params, *inputs))


def _compare(got, want, keys=KEYS):
    """rtol = atol = 1e-4. The mask logits reach |30|-|200| from random
    weights, and an entry near zero is the difference of such terms, so their
    atol is 1e-4 of the tensor's largest magnitude (float32 cancellation)."""
    for k in keys:
        w = np.asarray(want[k])
        atol = 1e-4 * max(1.0, float(np.abs(w).max())) if k == "pred_masks" else 1e-4
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4, atol=atol, err_msg=k)


def test_soc_forward_parity_b2(models, jax_forward):
    _, _, tm, inputs = models
    want = jax_forward
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in inputs))
    assert got["pred_masks"].shape == (1, 4, 2, 5, 12, 16)
    _compare(got, want)


def test_soc_all_layers_and_sample_sizes_b2(models):
    """vl_loss off emits every decoder layer; explicit per-sample sizes feed
    the relative coordinates of the mask head."""
    _, params, tm, inputs = models
    sizes = np.array([[48, 64], [40, 56]], np.float32)
    jm = JaxSOC(dropout=0.0, vl_loss=False, **KW)
    want = jax.jit(jm.apply)(params, *inputs, sizes)
    tm.vl_loss = False
    try:
        with torch.no_grad():
            got = tm(*(torch.from_numpy(a) for a in inputs), torch.from_numpy(sizes))
    finally:
        tm.vl_loss = True
    assert got["pred_masks"].shape[0] == 2
    _compare(got, want)


def test_head_of_backbone_features_equals_forward(models):
    _, _, tm, inputs = models
    px, pad, ids, msk = (torch.from_numpy(a) for a in inputs)
    with torch.no_grad():
        whole = tm(px, pad, ids, msk)
        split = tm.head(tm.backbone_features(px, pad), pad, ids, msk)
    for k in KEYS:
        torch.testing.assert_close(split[k], whole[k], rtol=0, atol=0)


def test_soc_pallas_window_attention_parity_b2(models, jax_forward):
    """swin_attn_impl='pallas' changes no parameter: the same state_dict
    loads strictly, and every Swin block runs the K3 plain version."""
    from neurips2023_soc_torch.ops.window_attention import window_attention

    _, _, tm, inputs = models
    pallas = SOC(swin_attn_impl="pallas", **KW)
    pallas.load_state_dict(tm.state_dict(), strict=True)
    window_attention.plain_calls = 0
    with torch.no_grad():
        got = pallas.eval()(*(torch.from_numpy(a) for a in inputs))
    assert window_attention.plain_calls == 12  # video-swin-t: 2 + 2 + 6 + 2 blocks
    _compare(got, jax_forward)
