"""The port's Ref-DAVIS-17 path on the CPU against the JAX package's, on a
small on-disk DAVIS download: `data/prepare_davis.py` (the same files and
JSON), `ReferDAVISDataset` (the same samples), `python -m
neurips2023_soc_torch.cli.infer_davis --device cpu` at configs/tiny_synthetic.yaml
(the anno_<k>/<video>/<frame>.png tree, its masks equal to the port engine's
infer_video_multi plus the merge), and `cli/eval_davis.py` on that tree (the
CSVs of the JAX CLI on the same tree). The JAX suite's
tests/test_eval_davis_cli.py cases run here on both sides."""
import csv
import json
import shutil
import sys

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from neurips2023_soc_torch.cli import eval_davis, infer_davis
from neurips2023_soc_torch.config import load_config
from neurips2023_soc_torch.data import prepare_davis
from neurips2023_soc_torch.data.davis import ReferDAVISDataset
from neurips2023_soc_torch.inference import (InferenceEngine, group_davis_annotator_order,
                                             merge_davis_annotator)
from neurips2023_soc_torch.models import build_model
from neurips2023_soc_tpu.cli import eval_davis as jax_eval_davis
from neurips2023_soc_tpu.data import prepare_davis as jax_prepare_davis
from neurips2023_soc_tpu.data.davis import ReferDAVISDataset as JaxDataset
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)

FRAMES = [f"{i:05d}" for i in range(6)]
PALETTE = bytes([0, 0, 0, 128, 0, 0, 0, 128, 0]) + bytes(768 - 9)


def _save_index_png(mask, path):
    img = Image.fromarray(mask.astype(np.uint8), mode="P")
    img.putpalette(PALETTE)
    img.save(path)


def _gt_masks(t):
    gt = np.zeros((48, 64), np.uint8)
    gt[8 + t:24 + t, 8:24] = 1
    gt[30:44, 40 - t:60 - t] = 2
    return gt


@pytest.fixture(scope="module")
def davis_raw(tmp_path_factory):
    """A raw Ref-DAVIS-17 download: one train and two val videos of six 48 x 64
    frames with 2 objects each, the four expression files (annotator 2's in
    latin-1, one video name misspelled as in the real files)."""
    root = tmp_path_factory.mktemp("davis_raw")
    davis = root / "DAVIS"
    (davis / "ImageSets" / "2017").mkdir(parents=True)
    (davis / "ImageSets" / "2017" / "train.txt").write_text("bear\n")
    (davis / "ImageSets" / "2017" / "val.txt").write_text("classic-car\ndogs-jump\n")
    rng = np.random.RandomState(0)
    semantics = {}
    for video in ("bear", "classic-car", "dogs-jump"):
        jpg = davis / "JPEGImages" / "480p" / video
        ann = davis / "Annotations_unsupervised" / "480p" / video
        jpg.mkdir(parents=True)
        ann.mkdir(parents=True)
        for t, name in enumerate(FRAMES):
            Image.fromarray(rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)).save(
                jpg / f"{name}.jpg")
            _save_index_png(_gt_masks(t), ann / f"{name}.png")
        semantics[video] = {"1": "car", "2": "dog"}
    (davis / "davis_semantics.json").write_text(json.dumps(semantics))
    txt = root / "davis_text_annotations"
    txt.mkdir()
    for stem, enc, extra in (("Davis17_annot1", "utf-8", ""),
                             ("Davis17_annot1_full_video", "utf-8", " all along"),
                             ("Davis17_annot2", "latin-1", " caf\xe9"),
                             ("Davis17_annot2_full_video", "latin-1", " na\xefve")):
        lines = []
        for video in ("bear", "clasic-car", "dogs-jump"):
            for obj in ("2", "1"):  # out of order: sorted by object id
                lines.append(f'{video} {obj} "the Object {obj} of {video}{extra}"')
        (txt / f"{stem}.txt").write_bytes(("\n".join(lines) + "\n").encode(enc))
    return root


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def davis_prepared(davis_raw, tmp_path_factory):
    out = tmp_path_factory.mktemp("davis_port")
    prepare_davis.prepare_ref_davis(str(davis_raw), str(out))
    return out


def test_prepare_davis_equals_jax(davis_raw, davis_prepared, tmp_path):
    jax_prepare_davis.prepare_ref_davis(str(davis_raw), str(tmp_path))
    assert _tree(davis_prepared) == _tree(tmp_path)
    for rel in _tree(tmp_path):
        assert (davis_prepared / rel).read_bytes() == (tmp_path / rel).read_bytes(), rel
    meta = json.loads((davis_prepared / "meta_expressions" / "valid"
                       / "meta_expressions.json").read_text())["videos"]
    assert sorted(meta) == ["classic-car", "dogs-jump"]
    exps = meta["classic-car"]["expressions"]
    assert [exps[str(i)]["obj_id"] for i in range(8)] == ["1"] * 4 + ["2"] * 4
    assert exps["2"]["exp"] == "the Object 1 of clasic-car caf\xe9"


def test_refer_davis_dataset_equals_jax(davis_prepared):
    kw = dict(transforms_kwargs=dict(eval_short_size=36, eval_max_size=48))
    port = ReferDAVISDataset("valid", str(davis_prepared), **kw)
    ref = JaxDataset("valid", str(davis_prepared), **kw)
    assert port.samples_list == ref.samples_list and len(port) == 16
    for i in (0, 5, 11):
        assert port.get_text(i) == ref.get_text(i)
        got, want = port[i], ref[i]
        assert got["text"] == want["text"] and got["video_metadata"] == want["video_metadata"]
        assert got["frames"].dtype == np.uint8 and got["frames"].shape == (6, 36, 48, 3)
        np.testing.assert_array_equal(got["frames"], want["frames"])


def _tiny_cfg(tmp_path, **overrides):
    with open("configs/tiny_synthetic.yaml") as f:
        raw = yaml.safe_load(f)
    for k, v in overrides.items():
        raw[k] = {"value": v}
    p = tmp_path / "cfg.yaml"
    p.write_text(yaml.safe_dump(raw))
    return str(p)


def _read_csvs(results):
    return {str(p.relative_to(results)): p.read_text() for p in sorted(results.rglob("*.csv"))}


def _eval_both(davis_path, results, tmp_path, monkeypatch, *extra):
    """The port's eval_davis on `results` and the JAX CLI on a copy; returns
    the port's CSV texts after asserting the JAX CLI wrote the same."""
    jax_results = tmp_path / "jax_results"
    shutil.copytree(results, jax_results)
    eval_davis.main(["--davis_path", str(davis_path), "--results_path", str(results),
                     "--set", "val", *extra])
    monkeypatch.setattr(sys, "argv", ["eval_davis", "--davis_path", str(davis_path),
                                      "--results_path", str(jax_results), "--set", "val",
                                      *extra])
    jax_eval_davis.main()
    got = _read_csvs(results)
    assert got == _read_csvs(jax_results) and len(got) == 9
    return got


@pytest.fixture(scope="module")
def davis_inferred(davis_prepared, tmp_path_factory):
    """`infer_davis --device cpu` at the tiny config over the prepared tree:
    two chunks of 4 frames per video (trajectory per chunk), 8 expressions."""
    tmp = tmp_path_factory.mktemp("davis_infer")
    out = tmp / "results"
    cfg = _tiny_cfg(tmp, img_folder=str(davis_prepared), eval_short_size=48,
                    eval_max_size=64, time_buckets=[4])
    assert infer_davis.main(["-c", cfg, "--device", "cpu", "--output_dir", str(out)]) == out
    return cfg, out


def test_infer_davis_cli_masks_equal_engine(davis_prepared, davis_inferred):
    cfg, out = davis_inferred
    config = load_config(cfg)
    engine = InferenceEngine(build_model(config, device="cpu"), device="cpu",
                             text_encoder_type=config.text_encoder_type,
                             text_bucket=config.text_bucket, time_buckets=(4,),
                             size_buckets=((48, 64), (64, 48)))
    ds = ReferDAVISDataset("valid", str(davis_prepared),
                           transforms_kwargs=dict(eval_short_size=48, eval_max_size=64))
    assert sorted(p.name for p in (out / "anno_0").iterdir()) == ["classic-car", "dogs-jump"]
    for video, start in (("dogs-jump", 8),):
        order = group_davis_annotator_order(list(range(start, start + 8)))
        probs = engine.infer_video_multi(ds[order[0]]["frames"],
                                         [ds.get_text(i) for i in order],
                                         original_size=(48, 64), return_probs=True,
                                         trajectory="chunk")
        for anno in range(4):
            want = merge_davis_annotator(probs[2 * anno:2 * anno + 2])
            d = out / f"anno_{anno}" / video
            assert sorted(p.name for p in d.iterdir()) == [f"{n}.png" for n in FRAMES]
            got = np.stack([np.array(Image.open(d / f"{n}.png")) for n in FRAMES])
            np.testing.assert_array_equal(got, want)


def test_eval_davis_on_the_infer_tree_equals_jax(davis_raw, davis_inferred, tmp_path,
                                                 monkeypatch):
    results = tmp_path / "results"
    shutil.copytree(davis_inferred[1], results)
    got = _eval_both(davis_raw / "DAVIS", results, tmp_path, monkeypatch)
    rows = list(csv.DictReader(got["global_results.csv"].splitlines()))
    assert [r["annotator"] for r in rows] == ["0", "1", "2", "3", "mean"]
    assert all(0.0 <= float(r["J&F-Mean"]) <= 1.0 for r in rows)


@pytest.fixture()
def davis_tree(tmp_path):
    """tests/test_eval_davis_cli.py's tree: perfect predictions for annotators
    0-2, shifted ones for annotator 3."""
    davis = tmp_path / "DAVIS"
    results = tmp_path / "results"
    (davis / "ImageSets" / "2017").mkdir(parents=True)
    (davis / "ImageSets" / "2017" / "val.txt").write_text("seq_a\nseq_b\n")
    for seq in ("seq_a", "seq_b"):
        gt_dir = davis / "Annotations_unsupervised" / "480p" / seq
        gt_dir.mkdir(parents=True)
        for anno in range(4):
            (results / f"anno_{anno}" / seq).mkdir(parents=True)
        for name in FRAMES:
            gt = np.zeros((48, 64), np.uint8)
            gt[8:24, 8:24] = 1
            gt[30:44, 40:60] = 2
            Image.fromarray(gt).convert("P").save(gt_dir / f"{name}.png")
            for anno in range(4):
                pred = np.roll(gt, 4, axis=1) if anno == 3 else gt
                Image.fromarray(pred).convert("P").save(
                    results / f"anno_{anno}" / seq / f"{name}.png")
    return davis, results


def test_eval_davis_cli_equals_jax(davis_tree, tmp_path, monkeypatch):
    davis, results = davis_tree
    got = _eval_both(davis, results, tmp_path, monkeypatch)
    rows = {r["annotator"]: r for r in csv.DictReader(got["global_results.csv"].splitlines())}
    for anno in ("0", "1", "2"):
        assert float(rows[anno]["J&F-Mean"]) > 0.99
    assert float(rows["3"]["J&F-Mean"]) < 0.99
    for anno in range(4):
        g = list(csv.DictReader(got[f"anno_{anno}/global_results-val.csv"].splitlines()))
        assert len(g) == 1 and list(g[0]) == eval_davis.G_MEASURES
        s = list(csv.DictReader(got[f"anno_{anno}/per-sequence_results-val.csv"]
                                .splitlines()))
        assert list(s[0]) == ["Sequence", "J-Mean", "F-Mean"]
        assert sorted(r["Sequence"] for r in s) == ["seq_a_1", "seq_a_2", "seq_b_1",
                                                    "seq_b_2"]


def test_eval_davis_semi_supervised_missing_id_equals_jax(tmp_path, monkeypatch):
    """Semi-supervised compares result object k with GT object k by id: a
    prediction that never emits id 1 scores ~0 on object 1's row and ~1 on a
    perfect object 2, instead of shifting object 2 onto object 1's row."""
    davis = tmp_path / "DAVIS"
    results = tmp_path / "results"
    (davis / "ImageSets" / "2017").mkdir(parents=True)
    (davis / "ImageSets" / "2017" / "val.txt").write_text("seq_a\n")
    gt_dir = davis / "Annotations" / "480p" / "seq_a"
    gt_dir.mkdir(parents=True)
    for anno in range(4):
        (results / f"anno_{anno}" / "seq_a").mkdir(parents=True)
    for name in FRAMES[:4]:
        gt = np.zeros((48, 64), np.uint8)
        gt[8:24, 8:24] = 1
        gt[30:44, 40:60] = 2
        Image.fromarray(gt).convert("P").save(gt_dir / f"{name}.png")
        pred = np.where(gt == 2, 2, 0).astype(np.uint8)  # id 1 never emitted
        for anno in range(4):
            Image.fromarray(pred).convert("P").save(results / f"anno_{anno}" / "seq_a"
                                                    / f"{name}.png")
    got = _eval_both(davis, results, tmp_path, monkeypatch, "--task", "semi-supervised")
    rows = {r["Sequence"]: float(r["J-Mean"]) for r in
            csv.DictReader(got["anno_0/per-sequence_results-val.csv"].splitlines())}
    assert rows["seq_a_1"] < 0.01 and rows["seq_a_2"] > 0.99


def test_infer_davis_defaults_to_the_card(davis_prepared, tmp_path):
    """Without --device the CLI asks for CUDA and raises on a host without it;
    it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is usable")
    cfg = _tiny_cfg(tmp_path, img_folder=str(davis_prepared))
    with pytest.raises(RuntimeError, match="CUDA"):
        infer_davis.main(["-c", cfg, "--output_dir", str(tmp_path / "o")])
