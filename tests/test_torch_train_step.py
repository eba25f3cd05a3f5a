"""One train step of the port against the JAX package's, on the CPU in
float32 at the tiny shape (video-swin-t, d_model 64, roberta-tiny, batch 2):
the training-mode outputs (every decoder layer), every loss term, the global
gradient norm and named gradients at 1e-4, with dropout switched off on both
sides.

JAX's Swin drop path has no off switch on SOC and its random stream cannot
be matched, so both sides run `head(backbone_features(x, training=False),
..., training=True)`; the JAX side's dropout (SOC.dropout 0, VOC's and
txt_proj's fixed 0.1) is switched off by making flax's Dropout the identity
while the step is traced, the port's by setting every Dropout module's rate
to 0."""
import numpy as np
import pytest

from neurips2023_soc_torch.data import SyntheticRVOSDataset, collate_batch
from neurips2023_soc_torch.models.text_encoder import build_tokenizer
from torch_port_helpers import assert_losses_and_gradients_match, train_step_pair
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)

KW = dict(backbone_name="video-swin-t", d_model=64, num_queries=5, dim_feedforward=128,
          enc_layers=1, dec_layers=2, voc_enc_layers=1, voc_dec_layers=1,
          text_encoder_type="roberta-tiny")


def _batch():
    """Two synthetic clips (the port's data) at 96 x 128, 2 frames: the
    stride-64 level is 2 x 2 (at 1 x 1 its GroupNorm over two values makes
    the backward ill-conditioned)."""
    ds = SyntheticRVOSDataset(num_samples=2, num_frames=2, frame_size=(96, 128), seed=3)
    tok = build_tokenizer("roberta-tiny", 8)
    return collate_batch([ds[0], ds[1]], tok, size_buckets=((96, 128),))


@pytest.fixture(scope="module")
def step():
    """Both models from the port's seeded init (sampling offsets moved off
    the pixel grid), the batch, the JAX side's training-mode outputs, loss
    terms and gradients from one compile, and the port's from one forward
    and backward."""
    return train_step_pair(_batch(), KW)


def test_training_forward_parity_all_layers(step):
    """Training mode emits every decoder layer (Le = dec_layers) with VOC
    run per layer; values as tests/test_torch_soc.py compares them."""
    _, jax_res, port = step
    want, got = jax_res["out"], port["out"]
    assert got["pred_masks"].shape[0] == KW["dec_layers"]
    for k in ("pred_masks", "pred_cls", "pred_boxes", "pred_logit", "text_sentence_feature"):
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        atol = 1e-4 * max(1.0, float(np.abs(w).max())) if k == "pred_masks" else 1e-4
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=1e-4, atol=atol,
                                   err_msg=k)


def test_train_step_losses_and_gradients_vs_jax(step):
    """Every loss term, the global gradient norm (over all parameters, the
    frozen text encoder's zeros included) and named gradients at 1e-4; a
    gradient's absolute tolerance is 1e-4 of its largest magnitude, as the
    mask logits' (f32 cancellation through the dynamic mask head)."""
    assert_losses_and_gradients_match(*step)
