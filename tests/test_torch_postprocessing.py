"""The port's postprocessing (neurips2023_soc_torch/models/postprocessing.py)
against the JAX package's jitted steps on the same seeded outputs, on the
CPU: scores within 1e-6; masks, RLE strings and selected boxes equal outside
threshold ties (pixels whose upsampled logit is within 1e-5 of 0, where the
two sides' last bits may round either way). The two postprocessing cases of
the JAX suite's tests/test_eval.py run here on both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurips2023_soc_torch.models import postprocessing as post
from neurips2023_soc_torch.ops.resize import resize_bilinear
from neurips2023_soc_tpu.models import postprocessing as jax_post
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)


def _outputs(seed, Lyr=2, T=2, B=3, Nq=5, h=12, w=16, K=1, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return {"pred_cls": rng.randn(Lyr, T, B, Nq, K).astype(dtype),
            "pred_masks": (4 * rng.randn(Lyr, T, B, Nq, h, w)).astype(dtype),
            "pred_boxes": rng.rand(Lyr, T, B, Nq, 4).astype(dtype)}


def _ties(masks_logits: np.ndarray, pad_h: int, pad_w: int) -> np.ndarray:
    """Pixels whose upsampled logit lies within 1e-5 of the 0.5 threshold."""
    up = resize_bilinear(torch.from_numpy(masks_logits)[..., None].float(), pad_h, pad_w)
    return (up[..., 0].abs() < 1e-5).numpy()


def _masks_equal_outside_ties(got, want, ties):
    assert got.shape == want.shape == ties.shape
    assert ((got == want) | ties).all(), f"{int(((got != want) & ~ties).sum())} pixels differ"


@pytest.mark.parametrize("pad", [(32, 48), (37, 53)])
def test_a2d_device_step_equals_jax(pad):
    out = _outputs(0)
    pc, pm = out["pred_cls"][-1], out["pred_masks"][-1]
    scores, masks = post.a2d_device_step(torch.from_numpy(pc), torch.from_numpy(pm), *pad)
    js, jm = jax_post.a2d_device_step(jnp.asarray(pc), jnp.asarray(pm), *pad)
    assert scores.dtype == torch.float32 and masks.dtype == torch.bool
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    ties = _ties(pm.reshape(-1, 5, 12, 16), *pad)
    _masks_equal_outside_ties(masks.numpy(), np.asarray(jm), ties)


def test_a2d_device_step_takes_bf16_logits():
    """The model's bf16 outputs: sigmoid and upsample in f32, as in JAX."""
    out = _outputs(1)
    pc = torch.from_numpy(out["pred_cls"][-1]).bfloat16()
    pm = torch.from_numpy(out["pred_masks"][-1]).bfloat16()
    scores, masks = post.a2d_device_step(pc, pm, 24, 32)
    want_s, want_m = post.a2d_device_step(pc.float(), pm.float(), 24, 32)
    assert scores.dtype == torch.float32
    assert torch.equal(scores, want_s) and torch.equal(masks, want_m)


def test_a2d_postprocess_equals_jax():
    """The host half (unpad, nearest resize to the original size, RLE) on the
    shapes of tests/test_eval.py's a2d_postprocess case."""
    out = _outputs(2, Lyr=2, T=1, B=2, Nq=4, h=8, w=8)
    sizes, orig = [(28, 30), (32, 26)], [(55, 61), (64, 50)]
    got = post.a2d_postprocess({k: torch.from_numpy(v) for k, v in out.items()}, (32, 32),
                               sizes, orig)
    want = jax_post.a2d_postprocess(out, (32, 32), sizes, orig)
    assert len(got) == len(want) == 2
    assert got[0]["masks"].shape == (4, 55, 61) and got[1]["scores"].shape == (4,)
    assert len(got[0]["rle_masks"]) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-6)
        assert g["masks"].dtype == np.uint8
        np.testing.assert_array_equal(g["masks"], w["masks"])
        assert g["rle_masks"] == w["rle_masks"]


def test_ytvos_device_step_selects_best_trajectory():
    T, B, Nq, h, w = 3, 2, 4, 8, 8
    pred_cls = np.full((T, B, Nq, 1), -5.0, np.float32)
    pred_cls[:, :, 2] = 5.0  # query 2 is the referred trajectory
    pred_masks = np.full((T, B, Nq, h, w), -10.0, np.float32)
    pred_masks[:, :, 2, :4, :4] = 10.0
    masks = post.ytvos_device_step(torch.from_numpy(pred_cls), torch.from_numpy(pred_masks),
                                   16, 16).numpy()
    assert masks.shape == (B, T, 16, 16)
    assert masks[:, :, :7, :7].all()
    assert not masks[:, :, 10:, 10:].any()
    np.testing.assert_array_equal(masks, np.asarray(jax_post.ytvos_device_step(
        jnp.asarray(pred_cls), jnp.asarray(pred_masks), 16, 16)))


def test_ytvos_postprocess_equals_jax():
    out = _outputs(3, T=4, B=2, Nq=5, K=3)
    metas = [{"video_id": "a", "resized_frame_size": (40, 60), "original_frame_size": (75, 101)},
             {"video_id": "b", "resized_frame_size": (48, 52), "original_frame_size": (48, 52)}]
    got = post.ytvos_postprocess({k: torch.from_numpy(v) for k, v in out.items()}, metas,
                                 (48, 64))
    want = jax_post.ytvos_postprocess(out, metas, (48, 64))
    sel = np.asarray(jax_post.ytvos_device_step(jnp.asarray(out["pred_cls"][-1]),
                                                jnp.asarray(out["pred_masks"][-1]), 48, 64))
    got_sel = post.ytvos_device_step(torch.from_numpy(out["pred_cls"][-1]),
                                     torch.from_numpy(out["pred_masks"][-1]), 48, 64).numpy()
    traj = (1 / (1 + np.exp(-out["pred_cls"][-1]))).mean(0).max(-1).argmax(-1)
    logits = out["pred_masks"][-1].transpose(1, 0, 2, 3, 4)[np.arange(2), :, traj]
    _masks_equal_outside_ties(got_sel, sel, _ties(logits, 48, 64))
    for g, w in zip(got, want):
        assert g["video_id"] == w["video_id"] and g["pred_masks"].dtype == np.uint8
        np.testing.assert_array_equal(g["pred_masks"], w["pred_masks"])


@pytest.mark.parametrize("K", [1, 3])
def test_coco_topk_device_step_equals_jax(K):
    out = _outputs(4, T=2, B=2, Nq=6, K=K)
    pc, pb = out["pred_cls"][-1], out["pred_boxes"][-1]
    pc[:, 1, :3] = 40.0  # saturated scores: ties that must keep their index order
    got = post.coco_topk_device_step(torch.from_numpy(pc), torch.from_numpy(pb))
    want = jax_post.coco_topk_device_step(jnp.asarray(pc), jnp.asarray(pb))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=1e-6)
