"""The port's training pieces against the JAX package's, on the CPU in
float32 at the tiny shape (video-swin-t, d_model 64, roberta-tiny): the
optimizer against optax on identical gradients (rtol = atol = 1e-6), VOC's
training windows (1e-4), dropout and drop path, the stop-gradient on refined
reference points, the synthetic data, a short Trainer run with checkpoint
and resume, and the per-epoch evaluation hook with best-by-mAP. One whole train step against JAX is in
tests/test_torch_train_step.py."""
import json
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neurips2023_soc_tpu.data.collate import collate_batch as jax_collate
from neurips2023_soc_tpu.data.synthetic import SyntheticRVOSDataset as JaxSynthetic
from neurips2023_soc_tpu.models.text_encoder import build_tokenizer as jax_tokenizer
from neurips2023_soc_tpu.models.voc import VOC as JaxVOC
from neurips2023_soc_tpu.training import optim as jax_optim
from neurips2023_soc_tpu.training.trainer import Trainer as JaxTrainer
from neurips2023_soc_torch.config import load_config
from neurips2023_soc_torch.data import SyntheticRVOSDataset, collate_batch, iterate_batches
from neurips2023_soc_torch.models.common import Dropout, init_weights
from neurips2023_soc_torch.models.soc import SOC
from neurips2023_soc_torch.models.text_encoder import build_tokenizer
from neurips2023_soc_torch.models.video_swin import build_video_swin, drop_path
from neurips2023_soc_torch.models.voc import VOC
from neurips2023_soc_torch.training import (Trainer, build_optimizer, load_torch_checkpoint,
                                            save_reference_checkpoint,
                                            update_milestones_from_microsteps)
from torch_port_helpers import apply_jax, init_jax, load, soc_state_dict
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)

KW = dict(backbone_name="video-swin-t", d_model=64, num_queries=5, dim_feedforward=128,
          enc_layers=1, dec_layers=2, voc_enc_layers=1, voc_dec_layers=1,
          text_encoder_type="roberta-tiny")


# ---------------------------------------------------------------- optimizer
class _Params(torch.nn.Module):
    """Named parameters in the three groups: `backbone.*`, `text_encoder.*`
    and the rest; `head.unused` never gets a gradient."""

    def __init__(self, tree):
        super().__init__()
        for group, leaves in tree.items():
            self.add_module(group, torch.nn.ParameterDict(
                {k: torch.nn.Parameter(torch.tensor(v)) for k, v in leaves.items()}))


def _tree(rng):
    return {"backbone": {"w": rng.randn(3, 4).astype(np.float32),
                         "b": rng.randn(4).astype(np.float32)},
            "text_encoder": {"w": rng.randn(4, 2).astype(np.float32)},
            "head": {"w": rng.randn(4, 2).astype(np.float32),
                     "unused": rng.randn(5).astype(np.float32)}}


@pytest.mark.parametrize("accum,freeze,scale", [(1, True, 1.0), (1, False, 1e-3),
                                                (2, False, 1.0), (2, True, 1e-3),
                                                (2, True, 1.0)])
def test_optimizer_vs_optax(accum, freeze, scale):
    """Three updates on identical gradients: the lr drops after the first
    update, clipping is active (scale 1) or not (1e-3), gradients are
    accumulated over 2 micro-steps or not (the frozen ones too: they enter
    the clip norm), and a frozen text encoder stays put while an unused
    parameter still decays."""
    rng = np.random.RandomState(accum * 10 + int(freeze))
    tree = _tree(rng)
    kw = dict(lr=1e-2, lr_backbone=3e-3, text_encoder_lr=5e-3, weight_decay=0.05,
              clip_max_norm=0.1, gamma=0.1, freeze_text=freeze, grad_accum_steps=accum)
    tx = jax_optim.build_optimizer({"params": tree}, milestones_steps=[1], **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, {"params": tree})
    jstate = tx.init(jparams)

    @jax.jit
    def jax_step(grads, state, params):
        upd, state = tx.update(grads, state, params)
        return optax.apply_updates(params, upd), state

    model = _Params(tree)
    opt = build_optimizer(model, milestones_steps=[1], **kw)
    for step in range(3 * accum):
        grads = {g: {k: (scale * rng.randn(*v.shape)).astype(np.float32)
                     for k, v in leaves.items()} for g, leaves in tree.items()}
        grads["head"]["unused"] = np.zeros_like(tree["head"]["unused"])
        jparams, jstate = jax_step({"params": grads}, jstate, jparams)
        for name, p in model.named_parameters():
            g, k = name.split(".")
            p.grad = None if k == "unused" else torch.tensor(grads[g][k])
        applied = opt.apply_gradients()
        assert applied == ((step + 1) % accum == 0)
        for name, p in model.named_parameters():
            g, k = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams["params"][g][k]),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{name} step {step}")
    assert opt.count == 3 and opt.lr("main") == pytest.approx(1e-3)
    np.testing.assert_array_equal(model.text_encoder.w.detach().numpy() == tree[
        "text_encoder"]["w"], np.full((4, 2), freeze))


def test_update_milestones_from_microsteps_vs_jax():
    for ms, k in (([20, 25], 4), ([1, 2, 3], 4), ([0, 8], 2), ([5], 1)):
        assert update_milestones_from_microsteps(ms, k) == \
            jax_optim.update_milestones_from_microsteps(ms, k)


def test_voc_training_windows_vs_jax():
    """With window_size > 0 every encoder layer uses plain windows in
    training (JAX voc.py:133) and every layer of frame queries goes in."""
    rng = np.random.RandomState(7)
    fq = rng.randn(2, 5, 2, 3, 16).astype(np.float32)  # (Lyr, T, B, Nq, C), T padded to 6
    lq = rng.randn(2, 16).astype(np.float32)
    kw = dict(input_dim=16, window_size=2, num_frame_queries=3, num_queries=3, num_heads=2,
              dim_feedforward=32, enc_layers=2, dec_layers=1)
    jm = JaxVOC(**kw)
    params = init_jax(jm, fq, lq, training=True)
    tm = load(VOC(16, 2, 3, 3, 2, 32, 2, 1), soc_state_dict(params, "voc", "voc."))
    for training in (True, False):
        want = apply_jax(jm, params, fq, lq, training=training)
        with torch.no_grad():
            got = tm(torch.from_numpy(fq), torch.from_numpy(lq), training=training)
        assert got.shape == want.shape == ((2 if training else 1), 2, 3, 16)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- pieces
def _soc():
    return init_weights(SOC(**KW), torch.Generator().manual_seed(0))


def test_drop_path_per_sample():
    x = torch.randn(6, 2, 3, 3, 4)
    assert drop_path(x, None, 0.3) is x  # eval / no generator
    assert drop_path(x, torch.zeros(6, dtype=torch.bool), 0.0) is x  # rate 0
    keep = torch.rand(6, generator=torch.Generator().manual_seed(0)) < 0.7
    y = drop_path(x, keep, 0.3)
    for i in range(6):
        want = x[i] / 0.7 if keep[i] else torch.zeros_like(x[i])
        torch.testing.assert_close(y[i], want, rtol=0, atol=0)


def test_backbone_drop_path_rates_and_masks():
    """Rates linspace(0, rate, depth) with the rate JAX's build_video_swin
    resolves; the masks come from the caller's generator and training with
    the same seed repeats itself, while inference ignores drop path."""
    swin_b = build_video_swin("video-swin-b")
    rates = [blk.drop_path for stage in swin_b.layers for blk in stage.blocks]
    np.testing.assert_allclose(rates, np.linspace(0, 0.2, 24), rtol=0, atol=1e-12)
    assert build_video_swin("swin-b").layers[-1].blocks[-1].drop_path == pytest.approx(0.3)
    body = _soc().backbone[0].body
    for blk in body.layers[-1].blocks:
        blk.drop_path = 0.5
    x = torch.randn(4, 2, 32, 32, 3)
    with torch.no_grad():
        a = body(x, torch.Generator().manual_seed(5))
        b = body(x, torch.Generator().manual_seed(5))
        c = body(x, torch.Generator().manual_seed(6))
        d, e = body(x), body(x)
    torch.testing.assert_close(a[-1], b[-1], rtol=0, atol=0)
    assert not torch.equal(a[-1], c[-1])
    torch.testing.assert_close(d[-1], e[-1], rtol=0, atol=0)


def test_training_needs_a_generator():
    tm = SOC(**KW)
    with pytest.raises(ValueError, match="rng"):
        tm.backbone_features(torch.zeros(2, 1, 32, 32, 3), None, training=True)


def test_dropout_masks_from_the_generator():
    d = Dropout(0.25)
    x = torch.randn(200, 50)
    assert d(x) is x
    y = d(x, torch.Generator().manual_seed(0))
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.75, rtol=0, atol=0)
    assert 0.7 < kept.float().mean().item() < 0.8
    torch.testing.assert_close(y, d(x, torch.Generator().manual_seed(0)), rtol=0, atol=0)


def test_refined_references_carry_no_gradient():
    """Box refinement's references are detached (JAX stop_gradient): a loss
    on the decoder states reaches no box head through them."""
    tm = _soc()
    t = tm.transformer
    rng = np.random.RandomState(2)
    shapes = ((6, 8), (3, 4), (2, 2), (1, 1))
    srcs = [torch.from_numpy(rng.randn(2, h, w, 64).astype(np.float32)) for h, w in shapes]
    masks = [torch.zeros(2, h, w, dtype=torch.bool) for h, w in shapes]
    hs, _, init_ref, inter, _ = t(srcs, masks, [s * 0 for s in srcs], tm.query_embed.weight,
                                  tm.bbox_embed)
    assert not inter.requires_grad and init_ref.requires_grad
    hs.sum().backward()
    assert all(p.grad is None for p in tm.bbox_embed.parameters())
    assert tm.transformer.reference_points.weight.grad is not None


def test_synthetic_data_equals_jax():
    """The port's dataset and collation give the JAX package's arrays."""
    port = SyntheticRVOSDataset(num_samples=3, num_frames=3, frame_size=(40, 72), seed=2)
    ref = JaxSynthetic(num_samples=3, num_frames=3, frame_size=(40, 72), seed=2)
    tok = build_tokenizer("roberta-tiny", 8)
    np.testing.assert_array_equal(np.stack(tok(["the red square moving left"])),
                                  np.stack(jax_tokenizer("roberta-tiny", 8)(
                                      ["the red square moving left"])))
    got = collate_batch([port[i] for i in range(3)], tok, size_buckets=((48, 80),))
    want = jax_collate([ref[i] for i in range(3)], tok, size_buckets=((48, 80),))
    assert sorted(got) == sorted(want)
    for k in want:
        if hasattr(want[k], "ndim"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


# ---------------------------------------------------------------- trainer
def _trainer(out_dir, epochs):
    cfg = load_config("configs/tiny_synthetic.yaml",
                      overrides={"output_dir": str(out_dir), "epochs": epochs})
    tok = build_tokenizer(cfg.text_encoder_type, cfg.text_bucket)
    ds = SyntheticRVOSDataset(num_samples=3, num_frames=2, frame_size=(64, 96), seed=0)
    return Trainer(cfg, lambda e: iterate_batches(ds, 1, tok, seed=e,
                                                  size_buckets=((64, 96),)), 3, device="cpu")


def test_trainer_three_steps_checkpoint_and_resume(tmp_path):
    tr = _trainer(tmp_path, epochs=1)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.train()
    assert len(tr.history) == 3
    for h in tr.history:
        assert all(np.isfinite(v) for v in h.values()) and h["grad_norm"] > 0
    after = tr.model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items()
               if k.startswith("text_encoder."))
    assert any(not torch.equal(after[k], v) for k, v in before.items()
               if k.startswith("backbone."))
    assert (tmp_path / "checkpoints" / "epoch_0000" / "state.pt").exists()
    assert len((tmp_path / "log.txt").read_text().splitlines()) == 1

    resumed = _trainer(tmp_path, epochs=2)
    resumed.load_checkpoint()
    assert resumed.epoch == 1 and resumed._state.step == 3
    assert resumed._state.optimizer.count == 3
    for k, v in resumed.model.state_dict().items():
        torch.testing.assert_close(v, after[k], rtol=0, atol=0)
    resumed.train()  # the second epoch only
    assert len(resumed.history) == 3 and resumed._state.step == 6
    assert len((tmp_path / "log.txt").read_text().splitlines()) == 2
    assert resumed.ckpt.latest_epoch() == 1

    ref = save_reference_checkpoint(resumed.model, tmp_path / "soc.pth.tar", epoch=1,
                                    total_epochs=2, best_loss=resumed.best_loss)
    sd = load_torch_checkpoint(ref)
    assert sorted(sd) == sorted(resumed.model.state_dict())
    assert all(torch.equal(sd[k], v) for k, v in resumed.model.state_dict().items())
    raw = torch.load(ref, weights_only=True)
    assert raw["epoch"] == 1 and raw["total_epochs"] == 2 and "optimizer_state_dict" in raw


def test_trainer_defaults_to_the_card():
    """Without device= the trainer asks for CUDA and raises when there is
    none (as on a CPU-only host); it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is usable")
    cfg = load_config("configs/tiny_synthetic.yaml")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, lambda e: iter(()), 1)


def test_trainer_evaluation_hook_and_best_map(tmp_path):
    """Two A2D epochs with a stub evaluate_fn whose mAP rises, then falls:
    log.txt carries the eval_ metrics, best_map and the best checkpoint
    follow JAX's _update_best, and resuming reads best_map back."""
    cfg = load_config("configs/tiny_synthetic.yaml", overrides={
        "output_dir": str(tmp_path), "epochs": 2, "dataset_name": "a2d_sentences"})
    tok = build_tokenizer(cfg.text_encoder_type, cfg.text_bucket)
    ds = SyntheticRVOSDataset(num_samples=1, num_frames=2, frame_size=(64, 96), seed=0,
                              center_frame_only=True)
    maps, calls = [0.3, 0.2], []

    def evaluate(model, epoch):
        calls.append((epoch, model is tr.model))
        return {"mAP 0.5:0.95": maps[epoch], "P@0.5": 0.5}

    tr = Trainer(cfg, lambda e: iterate_batches(ds, 1, tok, seed=e, size_buckets=((64, 96),)),
                 1, evaluate_fn=evaluate, device="cpu")
    tr.train()
    assert calls == [(0, True), (1, True)]
    logs = [json.loads(line) for line in (tmp_path / "log.txt").read_text().splitlines()]
    assert [log["eval_mAP 0.5:0.95"] for log in logs] == maps
    assert all(log["eval_P@0.5"] == 0.5 for log in logs)
    ref = SimpleNamespace(dataset_name="a2d_sentences", _is_pretrain=False, best_map=0.0,
                          best_loss=math.inf)
    want = [JaxTrainer._update_best(ref, {"mAP 0.5:0.95": m}, 1.0) for m in maps]
    assert want == [True, False] and tr.best_map == ref.best_map == 0.3
    assert tr.ckpt.best_epoch() == 0
    assert tr.ckpt.read_meta(1)["best_map"] == 0.3
    tr.best_map = 0.0
    tr.load_checkpoint()  # resume reads best_map back
    assert tr.best_map == 0.3 and tr.epoch == 2


@pytest.mark.parametrize("dataset", ["a2d_sentences", "coco", "ref_youtube_vos"])
def test_update_best_equals_jax(dataset):
    """Best by mAP 0.5:0.95 (A2D), by mean_mask_mAP when pretraining with val
    sets and by the train loss without them, else by the train loss."""
    port = Trainer.__new__(Trainer)
    port.dataset_name, port._is_pretrain = dataset, dataset == "coco"
    port.best_map, port.best_loss = 0.0, math.inf
    ref = SimpleNamespace(dataset_name=dataset, _is_pretrain=dataset == "coco",
                          best_map=0.0, best_loss=math.inf)
    for metrics, loss in (({"mAP 0.5:0.95": 0.2, "mean_mask_mAP": 0.1}, 5.0),
                          ({"mAP 0.5:0.95": 0.4, "mean_mask_mAP": 0.05}, 6.0),
                          ({"mAP 0.5:0.95": None, "mean_mask_mAP": 0.3}, 4.0),
                          ({}, 3.0), ({"mAP 0.5:0.95": 0.1}, 7.0)):
        assert port._update_best(metrics, loss) == JaxTrainer._update_best(ref, metrics, loss)
        assert (port.best_map, port.best_loss) == (ref.best_map, ref.best_loss)
