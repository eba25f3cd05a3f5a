"""The port's warm start against the JAX package's (the Kinetics and 2D Swin
converters, load_pretrained against load_pretrained_into_params and the
export to the reference's keys), its checkpoint loading paths, and its
training CLIs run end to end on the CPU at configs/tiny_synthetic.yaml's
widths over tiny on-disk fixtures: cli/main (A2D-Sentences train, resume,
test and pred; the synthetic dataset from the command line),
cli/main_pretrain (RefCOCO, single frames) and cli/main_joint. The JAX side
is only traced for its parameter shapes (jax.eval_shape): no SOC compiles."""
import argparse
import json
import re

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from neurips2023_soc_torch.cli import main as cli_main
from neurips2023_soc_torch.cli import main_joint, main_pretrain
from neurips2023_soc_torch.config import add_config_args, config_from_args, load_config
from neurips2023_soc_torch.convert import kinetics_swin_to_backbone, swin2d_to_backbone
from neurips2023_soc_torch.models import build_model
from neurips2023_soc_torch.training import Trainer
from neurips2023_soc_torch.training.checkpoint import (CheckpointManager, load_params_from_path,
                                                       load_pretrained,
                                                       save_reference_checkpoint)
from neurips2023_soc_tpu.config import add_config_args as jax_add_config_args
from neurips2023_soc_tpu.config import config_from_args as jax_config_from_args
from neurips2023_soc_tpu.config import load_config as jax_load_config
from neurips2023_soc_tpu.models import build_model as jax_build_model
from neurips2023_soc_tpu.training import convert as jax_convert
from neurips2023_soc_tpu.training.checkpoint import load_pretrained_into_params
from torch_port_helpers import jax_params_from_torch
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)
from torch_port_helpers import write_a2d_tree, write_refcoco_tree

TINY = "configs/tiny_synthetic.yaml"
BODY = "backbone.0.body."


def _model(seed):
    return build_model(load_config(TINY), device="cpu", seed=seed)


def _numpy_sd(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def assert_sd_equal(model, want):
    got = _numpy_sd(model)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------- warm start
def _kinetics_layout(model):
    """The tiny model's backbone as a Kinetics Video-Swin checkpoint would
    hold it: 'backbone.' keys, downsamples inside their layers, a temporal
    patch kernel of 2, plus a relative_position_index buffer and a classifier
    head that the converter drops."""
    sd = {}
    for k, v in _numpy_sd(model).items():
        if not k.startswith(BODY):
            continue
        k = re.sub(r"^downsamples\.(\d+)\.", r"layers.\1.downsample.", k[len(BODY):])
        if k == "patch_embed.proj.weight":
            v = np.concatenate([0.25 * v, 0.75 * v], axis=2)
        sd["backbone." + k] = v
    sd["backbone.layers.0.blocks.0.attn.relative_position_index"] = np.zeros((8, 8), np.int64)
    sd["cls_head.fc_cls.weight"] = np.ones((400, 8), np.float32)
    return sd


def test_kinetics_and_swin2d_converters_equal_jax():
    """Both converters give JAX's keys and arrays, and their output loads
    into the port's model with no unexpected key and every backbone key
    filled."""
    model = _model(0)
    kin = _kinetics_layout(model)
    twod = {k[len("backbone."):]: (v[:, :, 0] if k.endswith("patch_embed.proj.weight") else v)
            for k, v in kin.items() if k.startswith("backbone.")}
    twod.update({"head.weight": np.ones((1000, 8), np.float32), "norm.weight": np.ones(8),
                 "norm.bias": np.zeros(8)})
    backbone_keys = sorted(k for k in model.state_dict() if k.startswith(BODY))
    for port_fn, jax_fn, src in ((kinetics_swin_to_backbone, jax_convert.kinetics_swin_to_backbone,
                                  kin),
                                 (swin2d_to_backbone, jax_convert.swin2d_to_backbone, twod)):
        got, want = port_fn(src), jax_fn(src)
        assert sorted(got) == sorted(want) == backbone_keys
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        fresh = _model(1)
        res = fresh.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                                     for k, v in got.items()}, strict=False)
        assert res.unexpected_keys == [] and not any(k.startswith(BODY)
                                                     for k in res.missing_keys)
    np.testing.assert_allclose(kinetics_swin_to_backbone(kin)[BODY + "patch_embed.proj.weight"],
                               _numpy_sd(model)[BODY + "patch_embed.proj.weight"], rtol=1e-6)


@pytest.fixture(scope="module")
def jax_tiny_params():
    """The flax parameter tree of the tiny SOC (shapes by jax.eval_shape,
    values from the port's seed-0 model through the port's mapping)."""
    jm = jax_build_model(jax_load_config(TINY))
    px = np.zeros((2, 1, 64, 64, 3), np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), px, np.zeros((2, 1, 64, 64), bool),
                            np.zeros((1, 8), np.int32), np.ones((1, 8), np.int32))
    return {"params": jax_params_from_torch(_model(0), shapes["params"])}


@pytest.mark.parametrize("drop_class_embed", [False, True])
def test_load_pretrained_equals_jax(jax_tiny_params, tmp_path, drop_class_embed):
    """A reference .pth.tar with junk keys into a fresh model: the weights
    equal JAX's load_pretrained_into_params followed by export to the
    reference's keys, with the same missing and unused reports; with the
    class-head surgery the heads keep their initial values."""
    path = str(tmp_path / "zoo.pth.tar")
    save_reference_checkpoint(_model(5), path, best_map=0.4)
    ckpt = torch.load(path, weights_only=True)
    ckpt["model_state_dict"]["backbone.total_params"] = torch.zeros(1)
    ckpt["model_state_dict"]["not.a.real.key"] = torch.zeros(3)
    torch.save(ckpt, path)
    assert ckpt["best_mAP"] == pytest.approx(0.4)

    loaded, jreport = load_pretrained_into_params(path, jax_tiny_params,
                                                  drop_class_embed=drop_class_embed)
    want = jax_convert.export_torch_state_dict(loaded)
    model = _model(0)
    report = load_pretrained(model, path, drop_class_embed=drop_class_embed)
    assert_sd_equal(model, want)
    assert report["missing"] == sorted(tkey for _, tkey in jreport["missing"])
    assert report["unused"] == sorted(jreport["unused"]) == ["backbone.total_params",
                                                             "not.a.real.key"]
    assert bool(report["missing"]) == drop_class_embed
    assert all(k.startswith("class_embed") for k in report["missing"])


def test_load_weights_is_strict(tmp_path):
    """Trainer.load_weights rejects a checkpoint with an unexpected key and
    one with a missing key, before the model changes; strict=False loads
    what matches; the optimizer is not built."""
    trainer = Trainer(load_config(TINY, overrides={"output_dir": str(tmp_path / "run")}),
                      lambda epoch: iter(()), 1, device="cpu")
    source = _model(5)
    before = _numpy_sd(trainer.model)
    extra, short = str(tmp_path / "extra.pth.tar"), str(tmp_path / "short.pth.tar")
    save_reference_checkpoint(source, extra)
    ckpt = torch.load(extra, weights_only=True)
    ckpt["model_state_dict"]["not.a.real.key"] = torch.zeros(3)
    torch.save(ckpt, extra)
    del ckpt["model_state_dict"]["not.a.real.key"]
    del ckpt["model_state_dict"]["query_embed.weight"]
    torch.save(ckpt, short)
    for path, key in ((extra, "not.a.real.key"), (short, "query_embed.weight")):
        with pytest.raises(ValueError, match=re.escape(key)):
            trainer.load_weights(path)
        assert_sd_equal(trainer.model, before)
    trainer.load_weights(extra, strict=False)
    assert_sd_equal(trainer.model, _numpy_sd(source))
    assert trainer._state is None


def test_load_params_from_path_epoch_dir_and_root(tmp_path):
    """An epoch directory loads that epoch; a checkpoints root loads the best
    epoch (else the latest); a tensor saved with another shape is reported
    missing and keeps the model's value."""
    mgr = CheckpointManager(tmp_path / "checkpoints")
    sources = [_model(5), _model(6)]
    for epoch, src in enumerate(sources):
        mgr.save(epoch, {"model": src.state_dict(), "optimizer": {}, "step": 0},
                 is_best=epoch == 0)
    for path, src in ((tmp_path / "checkpoints" / "epoch_0001", sources[1]),
                      (tmp_path / "checkpoints", sources[0])):
        model = _model(0)
        assert load_params_from_path(model, path) == {"missing": [], "unused": []}
        assert_sd_equal(model, _numpy_sd(src))
    (tmp_path / "checkpoints" / "best.json").unlink()  # no best: the latest
    model = _model(0)
    load_params_from_path(model, tmp_path / "checkpoints")
    np.testing.assert_array_equal(_numpy_sd(model)["query_embed.weight"],
                                  _numpy_sd(sources[1])["query_embed.weight"])
    sd = sources[1].state_dict()
    sd["query_embed.weight"] = torch.zeros(3, 3)
    mgr.save(2, {"model": sd, "optimizer": {}, "step": 0}, is_best=False)
    model = _model(0)
    init = _numpy_sd(model)["query_embed.weight"]
    assert load_params_from_path(model, tmp_path / "checkpoints" / "epoch_0002") == {
        "missing": ["query_embed.weight"], "unused": []}
    np.testing.assert_array_equal(_numpy_sd(model)["query_embed.weight"], init)
    with pytest.raises(ValueError, match="query_embed.weight"):
        load_params_from_path(_model(0), tmp_path / "checkpoints" / "epoch_0002", strict=True)


# ---------------------------------------------------------------- the CLIs
def test_training_config_flags_equal_jax():
    """The training CLIs' flags set the config keys JAX's flags of the same
    names set, with the same defaults and -rm choices; the inference CLIs'
    parser still refuses them."""
    argv = ["-c", TINY, "-rm", "resume_train", "--epochs", "3", "-bs", "4", "--lr", "3e-4",
            "--lr_drop", "5", "7", "-ws", "6", "-pw", "w.pth", "-b", "video-swin-b", "-bpp",
            "b.pth", "-ckpt", "c.pth.tar", "--output_dir", "out", "--seed", "9",
            "--num_devices", "4", "--version", "v2", "--grad_accum_steps", "2"]
    for args in (argv, ["-c", TINY]):
        got = config_from_args(add_config_args(argparse.ArgumentParser(), training=True)
                               .parse_args(args))
        want = jax_config_from_args(jax_add_config_args(argparse.ArgumentParser())
                                    .parse_args(args))
        assert got.to_dict() == want.to_dict()
    assert got.running_mode == "train" and got.lr_drop == [20, 25]
    for bad in (["-rm", "eval"], ["-pw", "w"]):
        with pytest.raises(SystemExit):
            parser = add_config_args(argparse.ArgumentParser(), training=bad[0] == "-rm")
            parser.parse_args(["-c", TINY] + bad)


# eval at the fixtures' own frame size: the A2D evaluator's ground truth is the
# transformed mask, its predictions are at the original size (as in the JAX package)
SMALL = dict(train_short_size=32, train_max_size=48, eval_short_size=48, eval_max_size=64,
             batch_size=2, epochs=1, num_workers=2, text_bucket=12, eval_batch_size=1)


def _log(out_dir):
    return [json.loads(line) for line in (out_dir / "log.txt").read_text().splitlines()]


def _evals(rec):
    return {k: v for k, v in rec.items() if k.startswith("eval_")}


@pytest.fixture(scope="module")
def a2d_run(tmp_path_factory):
    """cli/main.run over the A2D fixture: one epoch of `train` (2 steps and
    the per-epoch evaluator), then `resume_train` to a second epoch."""
    root = tmp_path_factory.mktemp("a2d_cli")
    data = write_a2d_tree(root / "a2d")
    out = root / "out"
    cfg = load_config(TINY, overrides=dict(SMALL, dataset_name="a2d_sentences",
                                           img_folder=str(data), window_size=4,
                                           output_dir=str(out)))
    first, _ = cli_main.run(cfg, "train", device="cpu")
    resumed, _ = cli_main.run(cfg.replace(epochs=2), "resume_train", device="cpu")
    return cfg.replace(epochs=2), first, resumed, out


def test_main_train_and_resume(a2d_run):
    """Each epoch ran 2 steps (4 centre-frame samples, batch 2, valid
    indices on) and wrote its A2D metrics to log.txt; the resumed run
    started at epoch 1 from the written checkpoint."""
    cfg, first, resumed, out = a2d_run
    log = _log(out)
    assert [rec["epoch"] for rec in log] == [0, 1]
    for rec in log:
        assert np.isfinite(rec["train_loss"])
        for k in ("eval_mAP 0.5:0.95", "eval_P@0.5", "eval_overall_iou"):
            assert k in rec
    assert len(first.history) == len(resumed.history) == 2
    assert first.steps_per_epoch == 2 and resumed.epoch == 1
    assert resumed._state.step == 4
    assert sorted(p.name for p in (out / "checkpoints").glob("epoch_*")) == ["epoch_0000",
                                                                            "epoch_0001"]
    batch = next(iter(first.train_batches(0)))
    assert batch["pixels"].shape[:2] == (4, 2) and batch["valid_indices"].tolist() == [2, 2]


def test_main_test_and_pred_from_reference_checkpoint(a2d_run, tmp_path):
    """`test` on a .pth.tar written from the resumed model loads it strictly
    and gives exactly the epoch's eval metrics of log.txt; `pred` draws the
    val split's masks from the same weights."""
    cfg, _, resumed, out = a2d_run
    pth = str(tmp_path / "epoch1.pth.tar")
    save_reference_checkpoint(resumed.model, pth, epoch=1, total_epochs=2)
    cfg = cfg.replace(checkpoint_path=pth, output_dir=str(tmp_path / "eval"))
    _, metrics = cli_main.run(cfg, "test", device="cpu")
    assert {f"eval_{k}": v for k, v in metrics.items()} == _evals(_log(out)[-1])
    _, written = cli_main.run(cfg, "pred", device="cpu")
    jpgs = sorted((tmp_path / "eval" / "visualize" / "vid1").glob("*.jpg"))
    assert written == 2 and [p.name for p in jpgs] == ["v_vid1_f_12_i_1.jpg",
                                                       "v_vid1_f_1_i_1.jpg"]
    assert Image.open(jpgs[0]).size == (64, 48)


def test_main_cli_synthetic_and_refusals(tmp_path, monkeypatch):
    """`python -m neurips2023_soc_torch.cli.main -c configs/tiny_synthetic.yaml
    -rm train --device cpu` trains the synthetic dataset; an unknown flag is
    refused, and without a card every training CLI raises."""
    trainer, result = cli_main.main(["-c", TINY, "-rm", "train", "--device", "cpu",
                                     "--output_dir", str(tmp_path / "syn"), "--epochs", "1",
                                     "-ws", "2"])
    assert result is None and len(trainer.history) == 4
    assert trainer.config.dataset_name == "synthetic" and trainer.config.running_mode == "train"
    assert len(_log(tmp_path / "syn")) == 1
    for main in (cli_main.main, main_pretrain.main, main_joint.main):
        with pytest.raises(SystemExit):
            main(["-c", TINY, "--not_a_flag", "1", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (cli_main.main, main_pretrain.main, main_joint.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["-c", TINY, "--output_dir", str(tmp_path / "none")])
    assert not (tmp_path / "none").exists()


def test_profile_steps_writes_a_trace(tmp_path):
    """profile_steps = 1 wraps step 1 of the first epoch in a torch.profiler
    trace under output_dir/profile (a Chrome trace) that holds the model's
    spans."""
    cfg = load_config(TINY, overrides=dict(profile_steps=1, num_samples=4, window_size=2,
                                           output_dir=str(tmp_path / "out")))
    trainer, _ = cli_main.run(cfg, "train", device="cpu")
    assert len(trainer.history) == 2
    traces = list((tmp_path / "out" / "profile").glob("*.json"))
    assert len(traces) == 1
    names = {e["name"] for e in json.loads(traces[0].read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"soc.backbone", "soc.head"} <= names


def test_main_pretrain_single_frames(tmp_path):
    """cli/main_pretrain.run over the RefCOCO fixture: T = 1 batches, the
    per-split val metrics and their mean in log.txt, 10 kept checkpoints; then
    `test` from the epoch directory gives the logged metrics exactly."""
    data = write_refcoco_tree(tmp_path / "coco", train_ids=(1, 2, 3, 4))
    cfg = load_config(TINY, overrides=dict(SMALL, dataset_name="coco_refer", img_folder=str(data),
                                           ann_file="", window_size=2, eval_batch_size=2,
                                           output_dir=str(tmp_path / "out")))
    trainer, _ = main_pretrain.run(cfg, "train", device="cpu")
    assert next(iter(trainer.train_batches(0)))["pixels"].shape[:2] == (1, 2)
    assert len(trainer.history) == 2 and trainer.ckpt.max_keep == 10
    rec = _log(tmp_path / "out")[-1]
    for split in ("refcoco", "refcoco+"):
        for k in ("mAP 0.5:0.95", "bbox P@0.5", "recall@1"):
            assert f"eval_{split}_{k}" in rec
    assert rec["eval_mean_mask_mAP"] == pytest.approx(
        np.mean([rec["eval_refcoco_mAP 0.5:0.95"], rec["eval_refcoco+_mAP 0.5:0.95"]]))
    cfg = cfg.replace(checkpoint_path=str(tmp_path / "out" / "checkpoints" / "epoch_0000"))
    _, metrics = main_pretrain.run(cfg, "test", device="cpu")
    assert {f"eval_{k}": v for k, v in metrics.items()} == _evals(rec)


def test_main_joint_one_step(tmp_path):
    """cli/main_joint.main: one RefCOCO pseudo-clip and one Ref-YouTube-VOS
    window in one batch, one step, no evaluator (no valid split)."""
    data = write_refcoco_tree(tmp_path / "coco", train_ids=(1,))
    ytvos = tmp_path / "ytvos"
    frames = [f"{i:05d}" for i in range(4)]
    for sub in ("JPEGImages", "Annotations"):
        (ytvos / "train" / sub / "vid_a").mkdir(parents=True)
    rng = np.random.RandomState(3)
    for fi in frames:
        Image.fromarray(rng.randint(0, 255, (32, 48, 3), np.uint8)).save(
            ytvos / "train" / "JPEGImages" / "vid_a" / f"{fi}.jpg")
        ann = np.zeros((32, 48), np.uint8)
        ann[8:24, 10:30] = 1
        Image.fromarray(ann).convert("P").save(ytvos / "train" / "Annotations" / "vid_a" /
                                               f"{fi}.png")
    (ytvos / "train" / "meta.json").write_text(json.dumps(
        {"videos": {"vid_a": {"objects": {"1": {"category": "person"}}}}}))
    (ytvos / "meta_expressions" / "train").mkdir(parents=True)
    (ytvos / "meta_expressions" / "train" / "meta_expressions.json").write_text(json.dumps(
        {"videos": {"vid_a": {"frames": frames, "expressions": {
            "0": {"exp": "the Thing on the left", "obj_id": "1"}}}}}))
    with open(TINY) as f:
        raw = yaml.safe_load(f)
    for k, v in dict(SMALL, dataset_name="joint", img_folder=str(ytvos), window_size=4,
                     check_dataset_counts=False).items():
        raw[k] = {"value": v}
    cfg_path = tmp_path / "joint.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    trainer = main_joint.main(["-c", str(cfg_path), "--coco_folder", str(data), "--device", "cpu",
                               "--output_dir", str(tmp_path / "out")])
    assert trainer.steps_per_epoch == 1 and len(trainer.history) == 1
    assert trainer.evaluate_fn is None and np.isfinite(trainer.history[0]["loss"])
    batch = next(iter(trainer.train_batches(0)))
    assert batch["pixels"].shape[:2] == (4, 2)
