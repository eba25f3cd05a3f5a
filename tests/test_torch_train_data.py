"""The port's training data path against the JAX package's, on tiny on-disk
fixtures written here: A2D-Sentences (the annotation index from its csv and
h5 files, train and test windows decoded by range from an mp4),
JHMDB-Sentences, RefCOCO single frames and pseudo-clips with their warp
augmenter, the val split builder and the concatenation, the sharded epoch
sampler, the CLI's batch iterator and parallel_map. Every output is compared
key by key and must be equal (np.array_equal for pixels, masks, boxes and
metadata)."""
import random

import numpy as np
import pytest
from PIL import Image

import neurips2023_soc_tpu.cli.main as jax_main
import neurips2023_soc_tpu.data.a2d_sentences as jax_a2d
import neurips2023_soc_tpu.data.coco_ref as jax_coco
import neurips2023_soc_tpu.data.jhmdb_sentences as jax_jhmdb
import neurips2023_soc_tpu.data.sampler as jax_sampler
import neurips2023_soc_tpu.utils.prefetch as jax_prefetch
from neurips2023_soc_torch.cli import main as torch_main
from neurips2023_soc_torch.config import load_config
from neurips2023_soc_torch.data import a2d_sentences, coco_ref, jhmdb_sentences, sampler
from neurips2023_soc_torch.models.text_encoder import build_tokenizer
from neurips2023_soc_torch.utils import prefetch
from neurips2023_soc_tpu.config import load_config as jax_load_config
from neurips2023_soc_tpu.models.text_encoder import build_tokenizer as jax_build_tokenizer
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)
from torch_port_helpers import write_a2d_tree, write_refcoco_tree

A2D_TK = dict(horizontal_flip_augmentations=True, resize_and_crop_augmentations=True,
              random_color=True, train_short_size=32, train_max_size=48,
              eval_short_size=32, eval_max_size=48, seed=7)


def assert_same(got, want, where=""):
    """Equal structures: arrays by np.array_equal with the same dtype,
    everything else by ==."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        assert np.array_equal(got, want), where
    else:
        assert got == want, where


# ---------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def a2d_root(tmp_path_factory):
    return write_a2d_tree(tmp_path_factory.mktemp("a2d"))


@pytest.fixture(scope="module")
def jhmdb_root(tmp_path_factory):
    """Two JHMDB videos of 5 frames on disk, 3 and 5 of them annotated, under
    all 928 text lines (the loader checks the count)."""
    import scipy.io

    root = tmp_path_factory.mktemp("jhmdb")
    rng = np.random.RandomState(1)
    for vid, n_ann in (("clap_a", 3), ("wave_b", 5)):
        d = root / "Rename_Images" / "action" / vid
        d.mkdir(parents=True)
        for t in range(5):
            Image.fromarray(rng.randint(0, 255, (32, 40, 3), np.uint8)).save(
                d / f"{t + 1:05d}.png")
        md = root / "puppet_mask" / "action" / vid
        md.mkdir(parents=True)
        mask = np.zeros((32, 40, n_ann), np.uint8)
        mask[5:20, 10:30, :] = 1
        scipy.io.savemat(md / "puppet_mask.mat", {"part_mask": mask})
    lines = ["video_id,text"] + [f"{'clap_a' if i % 2 else 'wave_b'},Person {i} moving"
                                 for i in range(928)]
    (root / "jhmdb_annotation.txt").write_text("\n".join(lines) + "\n")
    return root


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return write_refcoco_tree(tmp_path_factory.mktemp("coco"))


def _configs(**overrides):
    kw = dict(dict(train_short_size=32, train_max_size=48, eval_short_size=32,
                   eval_max_size=48, window_size=8, batch_size=2, seed=5, num_workers=0,
                   text_bucket=12), **overrides)
    return (load_config("configs/tiny_synthetic.yaml", overrides=kw),
            jax_load_config("configs/tiny_synthetic.yaml", overrides=kw))


# ---------------------------------------------------------------- A2D / JHMDB
@pytest.mark.parametrize("subset", ["train", "test"])
def test_a2d_dataset_equals_jax(a2d_root, tmp_path, subset):
    """The annotation index (built from the csv and h5 files, then its JSON
    cache) and every sample over two epochs: the window decoded by range,
    clamped at both ends of the clip, the h5 mask transposed back, the
    train split's augmentation streams."""
    tk = A2D_TK if subset == "train" else {k: A2D_TK[k] for k in ("eval_short_size",
                                                                   "eval_max_size")}
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jax_a2d.A2DSentencesDataset(subset, str(a2d_root), window_size=8,
                                       transforms_kwargs=tk, cache_dir=str(tmp_path / "jax"))
    got = a2d_sentences.A2DSentencesDataset(subset, str(a2d_root), window_size=8,
                                            transforms_kwargs=tk,
                                            cache_dir=str(tmp_path / "port"))
    name = f"a2d_sentences_single_frame_{subset}_annotations.json"
    assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    assert got.text_annotations == want.text_annotations
    assert len(got) == {"train": 4, "test": 2}[subset]
    cached = a2d_sentences.build_text_annotations(str(a2d_root), subset, str(tmp_path / "port"))
    assert cached == want.text_annotations
    for epoch in (0, 1):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        for i in range(len(want)):
            assert_same(got[i], want[i], f"{subset} epoch {epoch} sample {i}")
    assert got[0]["frames"].shape[0] == 8 and got[0]["image_id"].startswith("v_vid")
    vp = str(a2d_root / "Release" / "clips320H" / "vid0.mp4")
    assert a2d_sentences.video_frame_count(vp) == jax_a2d.video_frame_count(vp) == 12
    assert a2d_sentences.get_image_id("v", 3, 2) == jax_a2d.get_image_id("v", 3, 2)


def test_jhmdb_dataset_equals_jax(jhmdb_root, tmp_path):
    """The sample index (3 random frames a video from one seeded stream, then
    its JSON cache) and samples whose window excludes the unannotated tail."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    tk = dict(eval_short_size=24, eval_max_size=32)
    want = jax_jhmdb.JHMDBSentencesDataset("test", str(jhmdb_root), window_size=4,
                                           transforms_kwargs=tk, cache_dir=str(tmp_path / "jax"))
    got = jhmdb_sentences.JHMDBSentencesDataset("test", str(jhmdb_root), window_size=4,
                                                transforms_kwargs=tk,
                                                cache_dir=str(tmp_path / "port"))
    assert got.samples_metadata == want.samples_metadata and len(got) == 3 * 928
    name = "jhmdb_sentences_samples_metadata.json"
    assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    tail = None
    for i in range(8):
        s = got[i]
        assert_same(s, want[i], f"sample {i}")
        if s["image_id"] == "v_clap_a_f_2":
            tail = s
    assert tail is not None
    # clap_a has 5 frames on disk and 3 annotated: the window [0, 3] of frame
    # 2 clamps to frame 2, never an unannotated frame
    np.testing.assert_array_equal(tail["frames"][-1], tail["frames"][-2])
    assert jhmdb_sentences.get_image_id("v", 3) == jax_jhmdb.get_image_id("v", 3)


# ---------------------------------------------------------------- RefCOCO
def test_augmenter_geometry_equals_jax():
    """The same RNG draws give the same warped image and masks (perspective,
    affine, brightness, and motion blur on some of the seeds)."""
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (48, 64, 3), np.uint8)
    mask = np.zeros((48, 64), np.uint8)
    mask[10:30, 20:50] = 1
    for seed in range(4):
        got = coco_ref.ImageToSeqAugmenter(rng=random.Random(seed))(img, [mask, 1 - mask])
        want = jax_coco.ImageToSeqAugmenter(rng=random.Random(seed))(img, [mask, 1 - mask])
        assert_same(got[0], want[0], f"seed {seed} image")
        for g, w in zip(got[1], want[1]):
            assert_same(g, w, f"seed {seed} mask")
        assert 0.3 * mask.sum() < got[1][0].sum() < 3 * mask.sum() + 1


@pytest.mark.parametrize("as_clip", [False, True])
def test_refcoco_clip_dataset_equals_jax(coco_root, as_clip):
    """Single frames (T = 1, pretraining) and 4-frame pseudo-clips (joint
    training) over two epochs."""
    tk = dict(A2D_TK, random_color=False)
    args = (str(coco_root / "annotations" / "finetune_refcoco_train.json"),
            str(coco_root / "train2014"))
    want = jax_coco.RefCOCOClipDataset(*args, num_frames=4, transforms_kwargs=tk, seed=3,
                                       as_clip=as_clip)
    got = coco_ref.RefCOCOClipDataset(*args, num_frames=4, transforms_kwargs=tk, seed=3,
                                      as_clip=as_clip)
    assert got.items == want.items and len(got) == 5
    for epoch in (0, 1):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        for i in range(len(want)):
            s = got[i]
            assert_same(s, want[i], f"as_clip {as_clip} epoch {epoch} sample {i}")
            assert s["frames"].shape[0] == (4 if as_clip else 1)


def test_refcoco_val_sets_and_concat_equal_jax(coco_root):
    """build_refcoco_val_datasets resolves the same splits and files, their
    single-frame samples are equal, and ConcatClipDataset indexes across its
    parts (and passes set_epoch on) as JAX's does."""
    cfg, jcfg = _configs(img_folder=str(coco_root), ann_file="")
    got, want = coco_ref.build_refcoco_val_datasets(cfg), jax_coco.build_refcoco_val_datasets(jcfg)
    assert [n for n, _ in got] == [n for n, _ in want] == ["refcoco", "refcoco+"]
    for (_, g), (_, w) in zip(got, want):
        assert g.items == w.items
        for i in range(len(w)):
            assert_same(g[i], w[i], f"val sample {i}")
    for name in ("refcoco", "refcocog"):
        assert coco_ref.find_refcoco_ann_file(name, "val", "", str(coco_root)) == \
            jax_coco.find_refcoco_ann_file(name, "val", "", str(coco_root))
    parts = [ds for _, ds in got]
    cat = coco_ref.ConcatClipDataset(parts)
    jcat = jax_coco.ConcatClipDataset([ds for _, ds in want])
    assert len(cat) == len(jcat) == 3
    cat.set_epoch(2)
    assert all(p._epoch == 2 for p in parts)
    for i in range(len(cat)):
        assert_same(cat[i], jcat[i], f"concat sample {i}")


# ---------------------------------------------------------------- sampling and batches
@pytest.mark.parametrize("num_hosts,host_id", [(1, 0), (2, 0), (2, 1), (3, 2)])
def test_sharded_epoch_sampler_equals_jax(num_hosts, host_id):
    for size in (10, 11):
        got = sampler.ShardedEpochSampler(size, num_hosts, host_id, seed=4)
        want = jax_sampler.ShardedEpochSampler(size, num_hosts, host_id, seed=4)
        orders = []
        for epoch in (0, 1):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            orders.append(list(got))
            assert orders[-1] == list(want) and len(got) == len(want)
        assert orders[0] != orders[1]  # reshuffled each epoch


@pytest.mark.parametrize("source,num_workers,time_buckets", [
    ("a2d", 0, None), ("a2d", 2, None), ("coco", 2, (1,))])
def test_make_batch_iterator_equals_jax(a2d_root, coco_root, tmp_path, source, num_workers,
                                        time_buckets):
    """Two epochs of the CLI's batches (sampler, set_epoch, worker threads,
    the ragged tail dropped, collation into the training buckets) equal JAX
    cli/main.make_batch_iterator's on the same dataset, one process."""
    cfg, jcfg = _configs(num_workers=num_workers)
    if source == "a2d":
        args = ("train", str(a2d_root))
        kw = dict(window_size=8, transforms_kwargs=A2D_TK, cache_dir=str(tmp_path))
        ds, jds = a2d_sentences.A2DSentencesDataset(*args, **kw), \
            jax_a2d.A2DSentencesDataset(*args, **kw)
    else:
        args = (str(coco_root / "annotations" / "finetune_refcoco_train.json"),
                str(coco_root / "train2014"))
        kw = dict(num_frames=8, transforms_kwargs=A2D_TK, seed=5, as_clip=False)
        ds, jds = coco_ref.RefCOCOClipDataset(*args, **kw), jax_coco.RefCOCOClipDataset(*args, **kw)
    got = torch_main.make_batch_iterator(ds, cfg, build_tokenizer("roberta-tiny", 12),
                                         num_hosts=1, host_id=0, time_buckets=time_buckets)
    want = jax_main.make_batch_iterator(jds, jcfg, jax_build_tokenizer("roberta-tiny", 12),
                                        num_hosts=1, host_id=0, time_buckets=time_buckets)
    for epoch in (0, 1):
        g, w = list(got(epoch)), list(want(epoch))
        assert len(g) == len(w) == len(ds) // 2
        for b, (gb, wb) in enumerate(zip(g, w)):
            assert_same(gb, wb, f"epoch {epoch} batch {b}")
        assert g[0]["pixels"].shape[0] == (1 if time_buckets else 8)


def test_parallel_map_equals_jax():
    """In input order at every worker count, inline at 0 and 1; a worker's
    exception re-raises at the consumer."""
    items = list(range(23))
    for workers in (0, 1, 3):
        got = list(prefetch.parallel_map(lambda x: x * x, items, workers))
        assert got == list(jax_prefetch.parallel_map(lambda x: x * x, items, workers))
        assert got == [x * x for x in items]

    def boom(x):
        if x == 5:
            raise ValueError("sample 5")
        return x

    with pytest.raises(ValueError, match="sample 5"):
        list(prefetch.parallel_map(boom, items, 3))
    assert list(prefetch.prefetch(iter(items), buffer_size=0)) == items
    assert list(prefetch.prefetch(iter(items), buffer_size=3)) == items
