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
import flax.linen
import jax
import numpy as np
import pytest
import torch

from neurips2023_soc_tpu.losses import CriterionConfig as JaxCriterionConfig
from neurips2023_soc_tpu.losses import compute_criterion as jax_criterion
from neurips2023_soc_tpu.losses import total_loss as jax_total_loss
from neurips2023_soc_tpu.models.soc import SOC as JaxSOC
from neurips2023_soc_torch.convert import load_jax_params, state_dict_from_jax
from neurips2023_soc_torch.data import SyntheticRVOSDataset, collate_batch
from neurips2023_soc_torch.losses import CriterionConfig, compute_criterion, total_loss
from neurips2023_soc_torch.models.common import Dropout, init_weights
from neurips2023_soc_torch.models.soc import SOC
from neurips2023_soc_torch.models.text_encoder import build_tokenizer
from neurips2023_soc_torch.training.optim import global_norm
from neurips2023_soc_torch.training.train_step import TARGET_KEYS
from torch_port_helpers import jax_params_from_torch

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


def _perturb_sampling_offsets(tree, rng):
    """At init the sampling offsets' kernel is zero, so every encoder sample
    sits exactly on a pixel centre, a kink of the bilinear sampling where the
    two frameworks' last-bit differences pick different one-sided slopes.
    A small random kernel moves the samples off the kinks."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb_sampling_offsets(v, rng) if k != "sampling_offsets" else {
                kk: (vv + 0.05 * rng.randn(*vv.shape)).astype(np.float32) if kk == "kernel"
                else vv for kk, vv in v.items()}
        else:
            out[k] = v
    return out


class _NoFlaxDropout:
    """flax's Dropout as the identity while a JAX function is traced."""

    def __enter__(self):
        self.saved = flax.linen.Dropout.__call__
        flax.linen.Dropout.__call__ = lambda self, inputs, deterministic=None, rng=None: inputs

    def __exit__(self, *exc):
        flax.linen.Dropout.__call__ = self.saved


@pytest.fixture(scope="module")
def step():
    """Both models from the port's seeded init (sampling offsets moved off
    the pixel grid), the batch, the JAX side's training-mode outputs, loss
    terms and gradients from one compile, and the port's from one forward
    and backward."""
    b = _batch()
    inputs = [b[k] for k in ("pixels", "pad_mask", "text_ids", "text_mask")]
    jm = JaxSOC(dropout=0.0, **KW)
    tm = init_weights(SOC(dropout=0.0, **KW), torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *inputs)
    params = {"params": jax_params_from_torch(tm, shapes["params"])}
    params = _perturb_sampling_offsets(params, np.random.RandomState(0))
    load_jax_params(tm, params)
    for m in tm.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    targets = {k: b[k] for k in TARGET_KEYS}

    def loss_fn(p):
        feats = jm.apply(p, b["pixels"], b["pad_mask"], method=jm.backbone_features)
        out = jm.apply(p, feats, b["pad_mask"], b["text_ids"], b["text_mask"],
                       sample_sizes=b["sample_sizes"], training=True, method=jm.head,
                       rngs={"dropout": jax.random.PRNGKey(1)})
        losses = jax_criterion(out, targets, JaxCriterionConfig())
        return jax_total_loss(losses, JaxCriterionConfig()), (losses, out)

    with _NoFlaxDropout():
        (loss, (losses, out)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params)

    t = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items() if hasattr(v, "ndim")}
    feats = tm.backbone_features(t["pixels"], t["pad_mask"])
    tout = tm.head(feats, t["pad_mask"], t["text_ids"], t["text_mask"],
                   sample_sizes=t["sample_sizes"], training=True, rng=torch.Generator())
    tlosses = compute_criterion(tout, {k: t[k] for k in TARGET_KEYS}, CriterionConfig())
    tloss = total_loss(tlosses, CriterionConfig())
    tloss.backward()
    return tm, dict(loss=loss, losses=losses, out=out, grads=grads), \
        dict(loss=tloss, losses=tlosses, out=tout)


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
    tm, jax_res, port = step
    jlosses, jgrads = jax_res["losses"], jax_res["grads"]
    losses, loss = port["losses"], port["loss"]
    assert sorted(losses) == sorted(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(losses[k].item(), float(jlosses[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(loss.item(), float(jax_res["loss"]), rtol=1e-4, atol=1e-4)
    want = state_dict_from_jax(jgrads)
    np.testing.assert_allclose(global_norm(p.grad for p in tm.parameters()).item(),
                               np.sqrt(sum(np.square(w, dtype=np.float64).sum()
                                           for w in want.values())), rtol=1e-4)
    got = dict(tm.named_parameters())
    for name in ("class_embed.1.weight", "bbox_embed.0.layers.2.bias", "controller.layers.0.weight",
                 "transformer.level_embed",
                 "transformer.encoder.layers.0.self_attn.sampling_offsets.weight",
                 "transformer.decoder.layers.1.cross_attn.value_proj.weight",
                 "voc.query_embed.weight", "txt_proj.fc.weight", "vlf.multihead_attn.in_proj_weight",
                 "backbone.0.body.layers.3.blocks.1.mlp.fc2.weight",
                 "backbone.0.body.patch_embed.proj.weight"):
        w = want[name]
        np.testing.assert_allclose(got[name].grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(np.abs(w).max())), err_msg=name)
    # the frozen encoder's gradient: zero in JAX (stop_gradient), none here
    assert all(p.grad is None for n, p in got.items() if n.startswith("text_encoder."))
    assert max(float(np.abs(v).max()) for k, v in want.items()
               if k.startswith("text_encoder.")) == 0.0
