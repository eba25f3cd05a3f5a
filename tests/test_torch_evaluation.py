"""The port's numpy evaluation modules (neurips2023_soc_torch/evaluation)
against the JAX package's: COCO RLE exactly (the same bytes), the COCO mask
mAP, P@K, RefExp box metrics and DAVIS J&F within 1e-12 on the same seeded
inputs. The cases of the JAX suite's tests/test_eval.py (RLE),
tests/test_coco_eval.py and tests/test_davis.py run here as cases, on both
sides, with their expected values."""
import numpy as np
import pytest

from neurips2023_soc_torch.evaluation import coco_eval, davis, refexp_eval, rle
from neurips2023_soc_tpu.evaluation import coco_eval as jax_coco_eval
from neurips2023_soc_tpu.evaluation import davis as jax_davis
from neurips2023_soc_tpu.evaluation import refexp_eval as jax_refexp_eval
from neurips2023_soc_tpu.evaluation import rle as jax_rle
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)

TOL = 1e-12


def _close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)


# ---------------------------------------------------------------- RLE
def _rle_mask(case):
    rng = np.random.RandomState(0)
    if case == "random":
        return (rng.rand(37, 53) > 0.5).astype(np.uint8)
    if case == "zeros":
        return np.zeros((10, 7), np.uint8)
    if case == "ones":
        return np.ones((10, 7), np.uint8)
    if case == "single":
        m = np.zeros((5, 5), np.uint8)
        m[2, 3] = 1
        return m
    if case == "stripes":
        return np.tile(np.array([[0, 1]], np.uint8), (8, 4))
    # long runs: counts above 2**5 and 2**10 exercise the multi-byte LEB128 path
    m = np.zeros((320, 576), np.uint8)
    m[40:300, 100:500] = 1
    m[rng.rand(320, 576) > 0.999] ^= 1
    return m


@pytest.mark.parametrize("case", ["random", "zeros", "ones", "single", "stripes", "long"])
def test_rle_equals_jax(case):
    m = _rle_mask(case)
    r = rle.encode(m)
    assert isinstance(r["counts"], bytes)
    assert r == jax_rle.encode(m)
    np.testing.assert_array_equal(rle.decode(r), m)
    np.testing.assert_array_equal(rle.decode(r), jax_rle.decode(r))
    ascii_rle = {"size": r["size"], "counts": r["counts"].decode("ascii")}
    np.testing.assert_array_equal(rle.decode(ascii_rle), m)
    assert rle.area(r) == jax_rle.area(r) == int(m.sum())


@pytest.mark.parametrize("case", ["random", "zeros", "ones", "single", "stripes", "long"])
def test_rle_native_counts_equal_numpy(case):
    """The C++ run counter (csrc/rle_counts.cpp) against its numpy version and
    the JAX package's numpy runs: the same counts, as int64."""
    m = _rle_mask(case)
    got = rle._counts_from_mask(m)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, rle.counts_numpy(m))
    np.testing.assert_array_equal(got, jax_rle._counts_from_mask(m))
    np.testing.assert_array_equal(rle._counts_from_mask(m[:0]), np.zeros(0, np.int64))


def test_rle_iou_equals_jax():
    a = np.zeros((20, 20), np.uint8)
    a[:10, :10] = 1
    b = np.zeros((20, 20), np.uint8)
    b[5:15, :10] = 1
    np.testing.assert_allclose(rle.iou([rle.encode(a)], [rle.encode(b)])[0, 0], 50 / 150,
                               atol=1e-9)
    rng = np.random.RandomState(1)
    dts = [rle.encode((rng.rand(23, 31) > p).astype(np.uint8)) for p in (0.3, 0.6, 0.9)]
    gts = [rle.encode((rng.rand(23, 31) > p).astype(np.uint8)) for p in (0.5, 0.8)]
    for crowd in (None, [0, 1]):
        np.testing.assert_array_equal(rle.iou(dts, gts, crowd), jax_rle.iou(dts, gts, crowd))


# ---------------------------------------------------------------- COCO mAP
def _sq(y0, x0, y1, x1, hw=(64, 64)):
    m = np.zeros(hw, np.uint8)
    m[y0:y1, x0:x1] = 1
    return rle.encode(m)


def _coco_scenario(name):
    """(gts, dts, expected metrics) of tests/test_coco_eval.py's cases, and a
    seeded one with several detections per image, crowd GT, area ranges and
    an image without GT."""
    gts, dts = [], []
    if name == "perfect":
        for i in range(4):
            seg = _sq(5 * i, 5 * i, 5 * i + 20, 5 * i + 20)
            gts.append({"image_id": i, "segmentation": seg, "iscrowd": 0})
            dts.append({"image_id": i, "segmentation": seg, "score": 0.9})
        return gts, dts, {"mAP 0.5:0.95": 1.0, "AP 0.5": 1.0}
    if name == "three_of_four":
        for i in range(4):
            seg = _sq(10, 10, 40, 40)
            gts.append({"image_id": i, "segmentation": seg, "iscrowd": 0})
            dts.append({"image_id": i, "segmentation": seg if i < 3 else _sq(50, 50, 60, 60),
                        "score": 0.9 if i < 3 else 0.8})
        # precision 1.0 up to recall 0.75, zero beyond -> 76/101
        return gts, dts, {"AP 0.5": 76 / 101, "mAP 0.5:0.95": 76 / 101}
    if name == "lower_iou":
        gts = [{"image_id": 0, "segmentation": _sq(0, 0, 30, 30), "iscrowd": 0}]
        dts = [{"image_id": 0, "segmentation": _sq(0, 0, 30, 24), "score": 0.9}]  # IoU 0.8
        # thresholds above 0.8 fail: 7 of 10 pass
        return gts, dts, {"AP 0.5": 1.0, "mAP 0.5:0.95": 0.7}
    rng = np.random.RandomState(3)
    for i in range(6):
        hw = (48 + 8 * i, 64)
        gm = np.zeros(hw, np.uint8)
        y, x, s = rng.randint(0, 20), rng.randint(0, 30), rng.randint(4, 28)
        gm[y:y + s, x:x + s] = 1
        gts.append({"image_id": f"img{i}", "segmentation": rle.encode(gm),
                    "iscrowd": int(i == 4)})
        for q in range(5):
            dm = np.roll(gm, rng.randint(-6, 7, 2), (0, 1)) if q < 2 else \
                (rng.rand(*hw) > 0.97).astype(np.uint8)
            dts.append({"image_id": f"img{i}", "segmentation": rle.encode(dm),
                        "score": float(rng.rand())})
    dts.append({"image_id": "no_gt", "segmentation": _sq(0, 0, 9, 9), "score": 0.99})
    return gts, dts, {}


@pytest.mark.parametrize("name", ["perfect", "three_of_four", "lower_iou", "seeded"])
def test_coco_map_equals_jax(name):
    gts, dts, expected = _coco_scenario(name)
    got = coco_eval.evaluate_coco_map(gts, dts)
    _close(got, jax_coco_eval.evaluate_coco_map(gts, dts))
    for k, v in expected.items():
        assert abs(got[k] - v) < 1e-6, (k, got[k], v)
    got_pr = coco_eval.precision_at_k_and_iou(gts, dts)
    _close(got_pr, jax_coco_eval.precision_at_k_and_iou(gts, dts))


def test_precision_at_k_and_iou():
    gts = [{"image_id": 0, "segmentation": _sq(0, 0, 30, 30)}]
    dts = [{"image_id": 0, "segmentation": _sq(0, 0, 30, 24), "score": 0.9},  # IoU 0.8
           {"image_id": 0, "segmentation": _sq(40, 40, 50, 50), "score": 0.1}]
    out = coco_eval.precision_at_k_and_iou(gts, dts)
    _close(out, jax_coco_eval.precision_at_k_and_iou(gts, dts))
    assert out["P@0.5"] == 1.0 and out["P@0.7"] == 1.0
    # iou = 0.8 + eps counts as > 0.8 (the reference's +1e-6 smoothing), 0.9 fails
    assert out["P@0.8"] == 1.0 and out["P@0.9"] == 0.0
    np.testing.assert_allclose(out["mean_iou"], 0.8, atol=1e-5)
    np.testing.assert_allclose(out["overall_iou"], 0.8, atol=1e-5)


def test_refexp_box_metrics_equal_jax():
    rng = np.random.RandomState(5)
    gt_boxes, dt = {}, {}
    for i in range(7):
        xy = rng.rand(2) * 50
        gt_boxes[i] = np.concatenate([xy, xy + 10 + rng.rand(2) * 40])[None].astype(np.float32)
        if i == 6:
            continue  # an image without predictions
        dt[i] = [{"box": gt_boxes[i][0] + rng.randn(4) * (3 if k < 2 else 30),
                  "score": float(rng.rand())} for k in range(12)]
    for ks in ((1, 5, 10), (1, 2)):
        _close(refexp_eval.evaluate_refexp_recall(gt_boxes, dt, ks=ks),
               jax_refexp_eval.evaluate_refexp_recall(gt_boxes, dt, ks=ks))
    _close(refexp_eval.bbox_precision_at_k_and_iou(gt_boxes, dt),
           jax_refexp_eval.bbox_precision_at_k_and_iou(gt_boxes, dt))


# ---------------------------------------------------------------- DAVIS J&F
def _clip_with_square(T, H, W, y0, x0, s):
    m = np.zeros((T, H, W), np.uint8)
    m[:, y0:y0 + s, x0:x0 + s] = 1
    return m


def _both(fn_name, *args, **kwargs):
    """The port's and the JAX package's davis.<fn_name> on the same inputs."""
    return (getattr(davis, fn_name)(*args, **kwargs),
            getattr(jax_davis, fn_name)(*args, **kwargs))


def _equal(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=TOL, atol=TOL)


def _case_iou_perfect_and_empty():
    gt = _clip_with_square(3, 32, 32, 4, 4, 10)
    empty = np.zeros_like(gt)
    for (a, b), want in (((gt, gt), 1.0), ((empty, empty), 1.0), ((gt, empty), 0.0)):
        got, ref = _both("db_eval_iou", a, b)
        _equal(got, ref)
        np.testing.assert_allclose(got, want)


def _case_boundary_perfect():
    gt = _clip_with_square(2, 64, 64, 10, 10, 20)
    got, ref = _both("db_eval_boundary", gt, gt)
    _equal(got, ref)
    np.testing.assert_allclose(got, 1.0)


def _case_boundary_offset_less_than_one():
    gt = _clip_with_square(1, 64, 64, 10, 10, 20)
    got, ref = _both("db_eval_boundary", gt, _clip_with_square(1, 64, 64, 30, 30, 20))
    _equal(got, ref)
    assert got[0] < 0.2


def _case_db_statistics_decay():
    got, ref = _both("db_statistics", np.linspace(1.0, 0.0, 20))  # degrading quality
    _equal(got, ref)
    m, r, d = got
    assert 0.45 < m < 0.55 and abs(r - 0.5) < 0.11 and d > 0.5


def _case_unsupervised_matching_picks_best_proposal():
    gt = _clip_with_square(3, 32, 32, 4, 4, 10)[None]
    props = np.stack([_clip_with_square(3, 32, 32, 20, 20, 8),
                      _clip_with_square(3, 32, 32, 4, 4, 10)])  # proposal 1 is right
    (j, f), (jr, fr) = _both("evaluate_unsupervised", gt, props)
    _equal(j, jr)
    _equal(f, fr)
    np.testing.assert_allclose(j[0], 1.0)
    np.testing.assert_allclose(f[0], 1.0)


def _case_evaluate_sequences_global():
    gt = _clip_with_square(4, 32, 32, 4, 4, 10)[None]
    got, ref = _both("evaluate_sequences", {"seq1": (gt, gt.copy())}, task="unsupervised")
    _equal(list(got["global"].values()), list(ref["global"].values()))
    assert abs(got["global"]["J&F-Mean"] - 1.0) < 1e-6
    assert got["global"]["J-Recall"] == 1.0


def _case_seeded_sequences():
    """Blobs with noisy edges, a void region, a missing proposal, both tasks,
    a frame size whose boundary radius is 8 pixels (480 x 854's is 8 too)."""
    rng = np.random.RandomState(7)
    T, H, W = 5, 300, 520
    yy, xx = np.mgrid[:H, :W]
    gts, preds = [], []
    for k in range(2):
        cy, cx, r = 80 + 120 * k, 120 + 200 * k, 50
        g = np.stack([((yy - cy - 4 * t) ** 2 + (xx - cx) ** 2 < r * r) for t in range(T)])
        gts.append(g.astype(np.uint8))
        preds.append((g ^ (rng.rand(T, H, W) > 0.995)).astype(np.uint8))
    gt, pred = np.stack(gts), np.stack(preds)
    for task in ("unsupervised", "semi-supervised"):
        got, ref = _both("evaluate_sequences", {"a": (gt, pred), "b": (gt, pred[:1])},
                         task=task)
        _equal(list(got["global"].values()), list(ref["global"].values()))
        assert got["per_object"].keys() == ref["per_object"].keys()
        _equal(list(got["per_object"].values()), list(ref["per_object"].values()))
    void = np.zeros((T, H, W), bool)
    void[:, :40] = True
    for fn in ("db_eval_iou", "db_eval_boundary"):
        got, ref = _both(fn, gt[0], pred[0], void)
        _equal(got, ref)


DAVIS_CASES = {
    "iou_perfect_and_empty": _case_iou_perfect_and_empty,
    "boundary_perfect": _case_boundary_perfect,
    "boundary_offset_less_than_one": _case_boundary_offset_less_than_one,
    "db_statistics_decay": _case_db_statistics_decay,
    "unsupervised_matching_picks_best_proposal":
        _case_unsupervised_matching_picks_best_proposal,
    "evaluate_sequences_global": _case_evaluate_sequences_global,
    "seeded_sequences": _case_seeded_sequences,
}


@pytest.mark.parametrize("case", list(DAVIS_CASES))
def test_davis_metrics_equal_jax(case):
    DAVIS_CASES[case]()


@pytest.mark.parametrize("radius", [0, 1, 3, 8, 13])
def test_disk_dilation_equals_jax(radius):
    """The port's running-sum dilation gives the JAX file's boolean map (its
    cv2.dilate, or its shift-or without OpenCV), a radius past the frame's
    height included."""
    rng = np.random.RandomState(radius)
    for shape in ((6, 9), (61, 87)):
        m = rng.rand(*shape) > 0.9
        np.testing.assert_array_equal(davis._dilate(m, radius), jax_davis._dilate(m, radius))
