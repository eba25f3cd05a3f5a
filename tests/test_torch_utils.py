"""The port's `utils` helpers against the JAX package's on the same numpy
inputs: masks_to_boxes, batch_videos and pad_instances exactly equal, and the
port's `utils` exports every public name of the JAX package's."""
import numpy as np
import pytest
import torch

import neurips2023_soc_torch.utils as tutils
import neurips2023_soc_tpu.utils as jutils
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)


def test_masks_to_boxes_equals_jax():
    """(2, 3, H, W) masks: random blobs, one empty mask, one single pixel, one
    touching the last row and column."""
    rng = np.random.RandomState(0)
    masks = (rng.rand(2, 3, 13, 17) > 0.97).astype(np.uint8)
    masks[0, 1] = 0
    masks[1, 0] = 0
    masks[1, 0, 4, 9] = 1
    masks[1, 2, -1, -1] = 1
    got = tutils.masks_to_boxes(torch.from_numpy(masks))
    want = np.asarray(jutils.masks_to_boxes(masks))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0, 1].numpy(), np.zeros(4, np.float32))
    np.testing.assert_array_equal(got[1, 0].numpy(), [9, 4, 9, 4])


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_batch_videos_equals_jax(dtype):
    """Ragged clips (3 and 5 frames, frames of several sizes) into one bucket."""
    rng = np.random.RandomState(1)
    videos = [[(rng.rand(h, w, 3) * 255).astype(dtype) for h, w in sizes]
              for sizes in (((240, 400), (250, 420), (240, 400)),
                            ((300, 500),) * 5)]
    kw = dict(size_buckets=((256, 448), (320, 576)), time_buckets=(4, 8), dtype=dtype)
    got = tutils.batch_videos(videos, **kw)
    want = jutils.batch_videos(videos, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (8, 2, 320, 576, 3)
    with pytest.raises(ValueError, match="time bucket"):
        tutils.batch_videos([videos[1] * 2], **kw)


@pytest.mark.parametrize("trailing", [(), (4,), (2, 3)])
def test_pad_instances_equals_jax(trailing):
    rng = np.random.RandomState(2)
    arrays = [rng.randn(n, *trailing).astype(np.float32) for n in (2, 0, 5)]
    got = tutils.pad_instances(arrays, 4, pad_value=-1)
    want = jutils.pad_instances(arrays, 4, pad_value=-1)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_utils_exports_every_jax_name():
    public = {n for n in dir(jutils) if not n.startswith("_")
              and not isinstance(getattr(jutils, n), type(jutils))}
    assert public <= set(tutils.__all__), sorted(public - set(tutils.__all__))
    assert tutils.DEFAULT_SIZE_BUCKETS == jutils.DEFAULT_SIZE_BUCKETS
    assert tutils.DEFAULT_TIME_BUCKETS == jutils.DEFAULT_TIME_BUCKETS
