"""The port's Ref-YouTube-VOS inference as a user runs it, on the CPU at the
tiny config, on the on-disk fixture of tests/test_infer_cli.py: the valid
split and its test-mode transforms against the JAX package's (exact), then
`python -m neurips2023_soc_torch.cli.infer_refytb --device cpu` (the JAX
CLI's Annotations/<video>/<exp>/<frame>.png layout and zip entries, masks
equal to the port engine's infer_video_multi on the same frames), and the
demo and predict CLIs."""
import json
import random
import zipfile

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from neurips2023_soc_torch.cli import demo_video, infer_refytb, predict
from neurips2023_soc_torch.config import load_config
from neurips2023_soc_torch.data.refer_youtube_vos import ReferYouTubeVOSDataset
from neurips2023_soc_torch.data.transforms import VideoTransforms
from neurips2023_soc_torch.inference import InferenceEngine
from neurips2023_soc_torch.models import build_model
from neurips2023_soc_torch.training import save_reference_checkpoint
from neurips2023_soc_tpu.data.refer_youtube_vos import ReferYouTubeVOSDataset as JaxDataset
from neurips2023_soc_tpu.data.transforms import VideoTransforms as JaxVideoTransforms
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)

FRAMES = [f"{i:05d}" for i in range(4)]
EXPECTED = [("vidA", "0"), ("vidA", "1"), ("vidB", "0")]


@pytest.fixture(scope="module")
def ytvos_valid_root(tmp_path_factory):
    """Two 4-frame 48 x 64 videos; vidA has two expressions (one shared
    backbone run), vidB one."""
    root = tmp_path_factory.mktemp("ytvos_infer")
    for vid in ["vidA", "vidB"]:
        d = root / "valid" / "JPEGImages" / vid
        d.mkdir(parents=True)
        for t, fi in enumerate(FRAMES):
            img = (np.random.RandomState(t).rand(48, 64, 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(d / f"{fi}.jpg")
    meta = {"videos": {
        "vidA": {"frames": FRAMES, "expressions": {"0": {"exp": "the moving thing"},
                                                   "1": {"exp": "the Other  thing"}}},
        "vidB": {"frames": FRAMES, "expressions": {"0": {"exp": "the moving thing"}}},
    }}
    for split, videos in (("valid", meta), ("test", {"videos": {}})):
        (root / "meta_expressions" / split).mkdir(parents=True)
        (root / "meta_expressions" / split / "meta_expressions.json").write_text(
            json.dumps(videos))
    return root


def _tiny_cfg(tmp_path, **overrides):
    with open("configs/tiny_synthetic.yaml") as f:
        raw = yaml.safe_load(f)
    for k, v in overrides.items():
        raw[k] = {"value": v}
    p = tmp_path / "cfg.yaml"
    p.write_text(yaml.safe_dump(raw))
    return str(p)


def test_valid_split_and_test_transforms_equal_jax(ytvos_valid_root, tmp_path):
    kw = dict(check_counts=False, transforms_kwargs=dict(eval_short_size=36,
                                                         eval_max_size=48))
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()  # separate metadata caches
    port = ReferYouTubeVOSDataset("test", str(ytvos_valid_root),
                                  metadata_dir=str(tmp_path / "p"), **kw)
    ref = JaxDataset("test", str(ytvos_valid_root), metadata_dir=str(tmp_path / "j"), **kw)
    assert (tmp_path / "p" / "valid_samples_metadata_win_8.json").exists()
    assert port.samples_list == ref.samples_list and len(port) == 3
    assert port.video_groups() == ref.video_groups() == {
        ("vidA", tuple(FRAMES)): [0, 1], ("vidB", tuple(FRAMES)): [2]}
    for i in range(len(port)):
        assert port.get_text(i) == ref.get_text(i) and port.exp_id(i) == ref.exp_id(i)
        got, want = port[i], ref[i]
        assert got["frames"].dtype == np.uint8 and got["frames"].shape == (4, 36, 48, 3)
        np.testing.assert_array_equal(got["frames"], want["frames"])
        assert got["text"] == want["text"] and got["video_metadata"] == want["video_metadata"]
    assert port.get_text(1) == "the other thing"

    frames = [np.random.RandomState(s).rand(30, 50, 3).astype(np.float32) for s in range(2)]
    masks = np.random.RandomState(9).randint(0, 2, (2, 1, 30, 50)).astype(np.uint8)
    boxes = np.array([[[3.0, 4.0, 20.0, 25.0]]] * 2, np.float32)
    for split in ("test", "train"):
        got = VideoTransforms(split, random_color=True)(
            list(frames), masks, boxes.copy(), "the left dog", rng=random.Random(3))
        want = JaxVideoTransforms(split, random_color=True)(
            list(frames), masks, boxes.copy(), "the left dog", rng=random.Random(3))
        for g, w in zip(got[0], want[0]):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert got[3] == want[3]


def _cfg(ytvos_valid_root, tmp_path, out_dir, **extra):
    return _tiny_cfg(tmp_path, dataset_name="ref_youtube_vos", img_folder=str(ytvos_valid_root),
                     eval_short_size=48, eval_max_size=64, eval_size_buckets=[[48, 64]],
                     time_buckets=[4], text_bucket=12, check_dataset_counts=False,
                     output_dir=str(out_dir), swin_attn_impl="pallas", **extra)


def test_infer_refytb_cli_end_to_end(ytvos_valid_root, tmp_path):
    """A reference-layout checkpoint (weights from seed 1) loads strictly into
    the CLI's seed-0 model; the PNG tree and zip are the JAX CLI's, and the
    masks equal the port engine's on the same frames and weights."""
    out_dir = tmp_path / "out"
    cfg = _cfg(ytvos_valid_root, tmp_path, out_dir)
    config = load_config(cfg)
    weights = build_model(config, device="cpu", seed=1)
    ckpt = save_reference_checkpoint(weights, tmp_path / "soc.pth.tar")
    infer_refytb.main(["-c", cfg, "-ckpt", str(ckpt), "--visualize",
                       "--device", "cpu"])

    names = sorted(zipfile.ZipFile(out_dir / "submission.zip").namelist())
    assert names == sorted(f"Annotations/{vid}/{exp}/{f}.png" for vid, exp in EXPECTED
                           for f in FRAMES)
    vis = sorted(p.relative_to(out_dir) for p in (out_dir / "valid_images").rglob("*.png"))
    assert [str(p) for p in vis] == sorted(f"valid_images/{vid}/{exp}/{f}.png"
                                           for vid, exp in EXPECTED for f in FRAMES)
    assert Image.open(out_dir / vis[0]).mode == "RGB"

    ds = ReferYouTubeVOSDataset("test", str(ytvos_valid_root), check_counts=False,
                                metadata_dir=str(tmp_path),
                                transforms_kwargs=dict(eval_short_size=48, eval_max_size=64))
    engine = InferenceEngine(weights, text_encoder_type="roberta-tiny", text_bucket=12,
                             time_buckets=(4,), size_buckets=((48, 64),), device="cpu")
    for g in ds.video_groups().values():
        s = ds[g[0]]
        want = engine.infer_video_multi(s["frames"], [ds.get_text(i) for i in g],
                                        original_size=s["video_metadata"]["original_frame_size"])
        for i, w in zip(g, want):
            vid = s["video_metadata"]["video_id"]
            got = np.stack([np.asarray(Image.open(
                out_dir / "Annotations" / vid / ds.exp_id(i) / f"{f}.png")) for f in FRAMES])
            assert got.shape == (4, 48, 64) and set(np.unique(got)) <= {0, 255}
            np.testing.assert_array_equal(got, w * 255)


def test_infer_refytb_profile_steps_writes_a_trace_of_the_spans(ytvos_valid_root, tmp_path):
    """profile_steps = 1 traces video 1 (vidB; video 0 warms up): one Chrome
    trace under output_dir/profile with its dispatch and head, and the
    collects of both videos (video 0's falls after video 1's dispatch)."""
    out_dir = tmp_path / "out"
    infer_refytb.main(["-c", _cfg(ytvos_valid_root, tmp_path, out_dir, profile_steps=1),
                       "--device", "cpu"])
    traces = list((out_dir / "profile").glob("*.json"))
    assert len(traces) == 1
    names = [e["name"] for e in json.loads(traces[0].read_text())["traceEvents"]
             if e.get("cat") == "user_annotation" and e["name"].startswith("soc.")]
    counts = {n: names.count(n) for n in set(names)}
    assert {k: counts.get(k) for k in ("soc.engine.dispatch", "soc.engine.upload",
                                       "soc.backbone", "soc.head", "soc.engine.finalize",
                                       "soc.engine.collect", "soc.engine.wait",
                                       "soc.engine.unpack")} == {
        "soc.engine.dispatch": 1, "soc.engine.upload": 1, "soc.backbone": 1, "soc.head": 1,
        "soc.engine.finalize": 1, "soc.engine.collect": 2, "soc.engine.wait": 2,
        "soc.engine.unpack": 2}
    assert (out_dir / "submission.zip").exists()


def test_infer_refytb_refuses_an_orbax_directory(ytvos_valid_root, tmp_path):
    cfg = _cfg(ytvos_valid_root, tmp_path, tmp_path / "out")
    with pytest.raises(ValueError, match="orbax"):
        infer_refytb.main(["-c", cfg, "-ckpt", str(tmp_path), "--device", "cpu"])


def test_infer_refytb_refuses_flags_it_does_not_read(ytvos_valid_root, tmp_path):
    """The JAX CLI's pretrained-weight flags load nothing here: passing one
    stops the CLI before it writes a submission from seeded weights."""
    cfg = _cfg(ytvos_valid_root, tmp_path, tmp_path / "out")
    for flag in ("-pw", "-bpp"):
        with pytest.raises(SystemExit):
            infer_refytb.main(["-c", cfg, flag, "weights.pth", "--device", "cpu"])
    assert not (tmp_path / "out").exists()


def test_demo_video_synthetic_writes_pngs(tmp_path):
    cfg = _tiny_cfg(tmp_path, time_buckets=[4], text_bucket=12)
    out_dir = tmp_path / "demo"
    masks = demo_video.main(["-c", cfg, "--synthetic", "--synthetic_frames", "4",
                             "--synthetic_size", "48", "64", "--output_dir", str(out_dir),
                             "--device", "cpu"])
    pngs = sorted(out_dir.glob("*.png"))
    assert [p.name for p in pngs] == [f"{t:05d}.png" for t in range(4)]
    assert masks.shape == (4, 48, 64)
    im = Image.open(pngs[0])
    assert im.size == (64, 48) and im.mode == "RGB"


def test_predict_cli_end_to_end(tmp_path):
    import cv2

    vp = str(tmp_path / "clip.mp4")
    vw = cv2.VideoWriter(vp, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    assert vw.isOpened()
    rng = np.random.RandomState(0)
    for _ in range(4):
        vw.write(rng.randint(0, 255, (48, 64, 3), np.uint8))
    vw.release()
    cfg = _tiny_cfg(tmp_path, eval_short_size=48, eval_max_size=64, time_buckets=[4],
                    text_bucket=12)
    out_dir = tmp_path / "pred"
    predict.main(["-c", cfg, "--video_path", vp, "--text", "the square",
                  "--output_dir", str(out_dir), "--device", "cpu"])
    pngs = sorted(out_dir.glob("*.png"))
    assert [p.name for p in pngs] == [f"{t:05d}.png" for t in range(4)]
    assert Image.open(pngs[0]).size == (64, 48)


def test_clis_default_to_the_card(tmp_path):
    """Without --device the CLIs ask for CUDA and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is usable")
    cfg = _tiny_cfg(tmp_path, time_buckets=[4], text_bucket=12)
    with pytest.raises(RuntimeError, match="CUDA"):
        demo_video.main(["-c", cfg, "--synthetic", "--synthetic_frames", "2",
                         "--synthetic_size", "32", "32", "--output_dir", str(tmp_path)])
