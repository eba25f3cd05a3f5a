"""The port's evaluators (neurips2023_soc_torch/evaluators.py) against the JAX
package's, on the CPU. Both sides are fed by a stub forward that returns the
same seeded outputs for the same batches (no SOC model compiles on either
side), so the comparison covers collation, the pipelined device and host
postprocess, RLE and the metrics: within 1e-9. The cases of the JAX suite's
tests/test_evaluators.py and tests/test_pretrain_eval.py run here on both
sides; the Ref-YouTube-VOS hook runs the tiny SOC once."""
import json
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from neurips2023_soc_torch import evaluators
from neurips2023_soc_torch.data import SyntheticRVOSDataset
from neurips2023_soc_torch.evaluation.rle import decode, encode
from neurips2023_soc_torch.models.text_encoder import build_tokenizer
from neurips2023_soc_torch.parallel import broadcast_object, gather_objects
from neurips2023_soc_tpu import evaluators as jax_evaluators
from neurips2023_soc_tpu.data.synthetic import SyntheticRVOSDataset as JaxSynthetic
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)

SIZE = (48, 64)
COLLATE = dict(size_buckets=(SIZE,), time_buckets=(4,))
NQ = 5


def _outputs(samples, seed):
    """Seeded SOC-shaped outputs for one batch (one emitted layer, the
    annotated frame only): query 0's stride-4 mask logits follow the sample's
    centre-frame mask with noise, the other queries are noise."""
    rng = np.random.RandomState(seed)
    B = len(samples)
    h, w = SIZE[0] // 4, SIZE[1] // 4
    masks = 3 * rng.randn(1, 1, B, NQ, h, w).astype(np.float32)
    for b, s in enumerate(samples):
        gt = s["masks"][0, 0][::4, ::4].astype(np.float32)
        masks[0, 0, b, 0] += 12 * (gt - 0.5)
    cls = rng.randn(1, 1, B, NQ, 1).astype(np.float32)
    cls[0, 0, :, 0] += 2.0
    boxes = np.clip(rng.rand(1, 1, B, NQ, 4), 0.05, 0.6).astype(np.float32)
    return {"pred_cls": cls, "pred_masks": masks, "pred_boxes": boxes}


class _StubSOC(torch.nn.Module):
    """SOC's inference signature; returns the next precomputed outputs and
    records the mode it was called in."""

    def __init__(self, outputs):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(()))
        self.outputs, self.calls = outputs, []

    def forward(self, pixels, pad_mask, text_ids, text_mask, sample_sizes=None,
                valid_indices=None, training=False):
        assert pixels.shape[2:4] == SIZE and valid_indices is not None and not training
        self.calls.append((self.training, torch.is_inference_mode_enabled()))
        return {k: torch.from_numpy(v) for k, v in self.outputs[len(self.calls) - 1].items()}


def _stubs(ds, batch_size):
    outs = [_outputs([ds[i] for i in range(s, min(s + batch_size, len(ds)))], seed=s)
            for s in range(0, len(ds), batch_size)]
    counter = iter(outs)
    return _StubSOC(outs), lambda params, batch: next(counter)


def _datasets(n=6, frames=4):
    kw = dict(num_samples=n, num_frames=frames, frame_size=SIZE, center_frame_only=True)
    return SyntheticRVOSDataset(**kw), JaxSynthetic(**kw)


def _close(got, want, tol=1e-9):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=tol, atol=tol, err_msg=k)


def test_a2d_evaluator_equals_jax(tmp_path):
    """tests/test_evaluators.py's end-to-end case: GT from the centre frames,
    the evaluator hook at batch 2 with a ragged tail, its COCO GT JSON."""
    ds, jds = _datasets(n=5)
    tok = build_tokenizer("roberta-tiny", 12)
    gts = evaluators.build_a2d_gt_annotations(ds)
    assert gts == jax_evaluators.build_a2d_gt_annotations(jds)
    assert len(gts) == 5 and all(g["area"] > 0 for g in gts)
    model, forward = _stubs(ds, 2)
    model.train()
    got = evaluators.build_a2d_evaluator(ds, tok, eval_batch_size=2, collate_kwargs=COLLATE,
                                         gt_json_path=str(tmp_path / "gt.json"))(model, 3)
    want = jax_evaluators.build_a2d_evaluator(
        jds, tok, eval_batch_size=2, collate_kwargs=COLLATE,
        gt_json_path=str(tmp_path / "jax_gt.json"))(forward, None, 3)
    _close(got, want)
    assert "mAP 0.5:0.95" in got and "P@0.5" in got
    assert 0.0 < got["mAP 0.5:0.95"] <= 1.0
    # eval mode under inference_mode for every forward, and the mode given back
    assert model.calls == [(False, True)] * 3 and model.training
    assert json.loads((tmp_path / "gt.json").read_text()) == json.loads(
        (tmp_path / "jax_gt.json").read_text())


def test_write_coco_gt_json_equals_jax(tmp_path):
    """The dataset_coco_gt_format_path JSON in the reference's layout
    (create_gt_in_coco_format.py:43-95), equal to the JAX file's as parsed
    JSON, its RLEs decoding back exactly."""
    rng = np.random.RandomState(0)
    masks = [(rng.rand(17, 23) > 0.6).astype(np.uint8) for _ in range(3)]
    masks.append(np.zeros((9, 9), np.uint8))  # an empty mask: a zero bbox
    gts = [{"image_id": f"img_{i}", "segmentation": encode(m), "iscrowd": 0,
            "area": int(m.sum())} for i, m in enumerate(masks)]
    evaluators.write_coco_gt_json(gts, str(tmp_path / "port.json"))
    jax_evaluators.write_coco_gt_json(gts, str(tmp_path / "jax.json"))
    d = json.loads((tmp_path / "port.json").read_text())
    assert d == json.loads((tmp_path / "jax.json").read_text())
    assert d["categories"] == [{"id": 1, "name": "dummy_class"}]
    assert [im["id"] for im in d["images"]] == [f"img_{i}" for i in range(4)]
    for i, ann in enumerate(d["annotations"]):
        assert ann["category_id"] == 1 and ann["iscrowd"] == 0
        assert isinstance(ann["segmentation"]["counts"], str)  # ascii, not bytes
        np.testing.assert_array_equal(decode(ann["segmentation"]), masks[i])
    assert d["annotations"][3]["bbox"] == [0.0, 0.0, 0.0, 0.0]


def test_pretrain_eval_protocol_equals_jax():
    """tests/test_pretrain_eval.py's case: mask mAP, P@K, box recall@k and
    box P@K of the RefCOCO pretrain protocol."""
    ds, jds = _datasets(n=4)
    tok = build_tokenizer("roberta-tiny", 12)
    gt_anns = evaluators.build_a2d_gt_annotations(ds)
    gt_boxes = {ds[i]["image_id"]: ds[i]["boxes"][0] for i in range(len(ds))}
    from neurips2023_soc_torch.data import collate_batch

    def batches(d):
        for s in range(0, len(d), 2):
            yield collate_batch([d[s], d[s + 1]], tok, **COLLATE)

    model, forward = _stubs(ds, 2)
    got = evaluators.evaluate_coco_pretrain_batches(model, batches(ds), gt_anns, gt_boxes)
    want = jax_evaluators.evaluate_coco_pretrain_batches(forward, None, batches(jds),
                                                         gt_anns, gt_boxes)
    _close(got, want)
    for key in ("mAP 0.5:0.95", "P@0.5", "recall@1", "recall@5", "bbox P@0.5",
                "bbox mean_iou"):
        assert np.isfinite(got[key]), key


class _RefCocoVal:
    """A RefCOCO val split's interface (items, imgs, single-frame samples)
    over synthetic centre-frame samples; the GT segmentations are RLE."""

    def __init__(self, ds):
        self.ds = ds
        self.items, self.imgs = [], {}
        for i in range(len(ds)):
            s = ds[i]
            m = s["masks"][0, 0]
            ys, xs = np.nonzero(m)
            rle = encode(m)
            self.items.append((s["image_id"], [{
                "segmentation": {"counts": rle["counts"].decode()},
                "bbox": [float(xs.min()), float(ys.min()), float(np.ptp(xs) + 1),
                         float(np.ptp(ys) + 1)]}]))
            self.imgs[s["image_id"]] = {"height": m.shape[0], "width": m.shape[1]}

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i]


def test_pretrain_evaluator_equals_jax():
    """build_pretrain_evaluator over two val splits: prefixed metrics and the
    checkpoint-selection scalar mean_mask_mAP."""
    tok = build_tokenizer("roberta-tiny", 12)
    kw = dict(num_samples=4, num_frames=1, frame_size=SIZE, center_frame_only=True)
    splits = [(name, SyntheticRVOSDataset(seed=k, **kw)) for k, name in enumerate(("a", "b"))]
    outs = [_outputs([d[2 * j], d[2 * j + 1]], seed=10 * k + j)
            for k, (_, d) in enumerate(splits) for j in range(2)]
    model = _StubSOC(outs)
    counter = iter(outs)
    port_sets = [(n, _RefCocoVal(d)) for n, d in splits]
    jax_sets = [(n, _RefCocoVal(JaxSynthetic(seed=k, **kw))) for k, (n, _) in enumerate(splits)]
    got = evaluators.build_pretrain_evaluator(port_sets, tok, eval_batch_size=2,
                                              size_buckets=(SIZE,))(model, 0)
    want = jax_evaluators.build_pretrain_evaluator(jax_sets, tok, eval_batch_size=2,
                                                   size_buckets=(SIZE,))(
        lambda p, b: next(counter), None, 0)
    _close(got, want)
    assert got["mean_mask_mAP"] == pytest.approx((got["a_mAP 0.5:0.95"]
                                                  + got["b_mAP 0.5:0.95"]) / 2)


def test_predict_visualize_equals_jax(tmp_path):
    """tests/test_evaluators.py's `-rm pred` case: the best mask overlaid on
    the denormalized annotated frame, one JPG per sample, the same pixels as
    the JAX package's."""
    ds, jds = _datasets(n=3)
    tok = build_tokenizer("roberta-tiny", 12)
    model, forward = _stubs(ds, 2)
    n = evaluators.run_predict_visualize(model, ds, tok, str(tmp_path / "port"),
                                         eval_batch_size=2, collate_kwargs=COLLATE)
    jax_evaluators.run_predict_visualize(forward, None, jds, tok, str(tmp_path / "jax"),
                                         eval_batch_size=2, collate_kwargs=COLLATE)
    assert n == 3
    files = sorted((tmp_path / "port").rglob("*.jpg"))
    assert [f.name for f in files] == [f"synthetic_{i}.jpg" for i in range(3)]
    for f, s in zip(files, [ds[i] for i in range(3)]):
        img = np.asarray(Image.open(f))
        assert img.shape == tuple(s["orig_size"]) + (3,)
        np.testing.assert_array_equal(img, np.asarray(Image.open(tmp_path / "jax" / f.name)))


def test_gather_and_broadcast_in_one_process():
    obj = {"a": [1, 2]}
    assert gather_objects(obj) == [obj]
    assert broadcast_object(obj) is obj


class _Videos:
    """The ReferYouTubeVOSDataset (test split) interface over two synthetic
    videos; video 0 has two expressions."""

    def __init__(self):
        rng = np.random.RandomState(0)
        self.frames = [rng.randint(0, 256, (3, 48, 64, 3)).astype(np.uint8) for _ in range(2)]
        self.rows = [(0, "0", "the red square"), (0, "1", "the blue one"), (1, "0", "a cat")]

    def video_groups(self):
        return {("v0",): [0, 1], ("v1",): [2]}

    def get_text(self, i):
        return self.rows[i][2]

    def exp_id(self, i):
        return self.rows[i][1]

    def __getitem__(self, i):
        v = self.rows[i][0]
        return {"frames": self.frames[v], "video_metadata": {
            "video_id": f"v{v}", "frame_indices": ["00000", "00001", "00002"],
            "original_frame_size": (48, 64), "exp_id": self.rows[i][1]}}


def test_ytvos_evaluator_writes_the_submission_zip(tmp_path):
    from neurips2023_soc_torch.config import load_config
    from neurips2023_soc_torch.models import build_model

    cfg = load_config("configs/tiny_synthetic.yaml", overrides={
        "output_dir": str(tmp_path), "dataset_name": "ref_youtube_vos",
        "eval_short_size": 48, "eval_max_size": 64, "eval_time_buckets": [4]})
    model = build_model(cfg, device="cpu").train()
    evaluate = evaluators.build_ytvos_evaluator(model, cfg, dataset=_Videos())
    out = evaluate(model, 2)
    zpath = tmp_path / "validation_outputs" / "submission_epoch_2.zip"
    assert out == {"submission_zip": str(zpath)} and model.training
    assert not (tmp_path / "validation_outputs" / "epoch_2").exists()
    names = sorted(zipfile.ZipFile(zpath).namelist())
    assert names == sorted(f"Annotations/{v}/{e}/0000{t}.png"
                           for v, e in (("v0", "0"), ("v0", "1"), ("v1", "0"))
                           for t in range(3))
