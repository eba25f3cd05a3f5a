"""The train step of the two other training modes, the port's
against the JAX package's on the CPU in float32 at the tiny shape, through
tests/test_torch_train_step.py's helpers (torch_port_helpers): an A2D step, whose
batch annotates only each clip's centre frame and whose head takes the
`valid_indices` rows, and a pretraining step on single frames (B = 2,
T = 1), the one Video-Swin pass with a temporal patch pad and windows clamped
to one frame. Each compares every loss term, the total, the global gradient
norm and named gradients at the existing file's tolerances (1e-4).

A test point must be one where the port agrees with itself: the single-frame
batch of seed 4 has a backward whose gradients move by 1e-3 of their scale
between 1 and 8 torch threads (summation order alone), above the tolerance,
so the single-frame step uses seed 3 (the existing file's seed), where they
move by 3e-6, as the A2D batch of seed 4 does."""
import pytest

from neurips2023_soc_torch.data import SyntheticRVOSDataset, collate_batch
from neurips2023_soc_torch.models.text_encoder import build_tokenizer
from torch_port_helpers import assert_losses_and_gradients_match, train_step_pair
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)

KW = dict(backbone_name="video-swin-t", d_model=64, num_queries=5, dim_feedforward=128,
          enc_layers=1, dec_layers=2, voc_enc_layers=1, voc_dec_layers=1,
          text_encoder_type="roberta-tiny")


def _batch(num_frames, center_frame_only, seed):
    """Two synthetic clips at 96 x 128 (the stride-64 level is 2 x 2)."""
    ds = SyntheticRVOSDataset(num_samples=2, num_frames=num_frames, frame_size=(96, 128),
                              seed=seed, center_frame_only=center_frame_only)
    tok = build_tokenizer("roberta-tiny", 8)
    return collate_batch([ds[0], ds[1]], tok, size_buckets=((96, 128),),
                         time_buckets=(num_frames,))


@pytest.fixture(scope="module")
def a2d_step():
    b = _batch(3, center_frame_only=True, seed=4)
    assert b["valid_indices"].tolist() == [1, 1] and b["masks"].shape[0] == 1
    return train_step_pair(b, KW, valid_indices=True)


@pytest.fixture(scope="module")
def pretrain_step():
    b = _batch(1, center_frame_only=False, seed=3)
    assert b["pixels"].shape[:2] == (1, 2) and "valid_indices" not in b
    return train_step_pair(b, KW)


def test_a2d_valid_indices_step_vs_jax(a2d_step):
    tm, jax_res, port = a2d_step
    assert port["out"]["pred_masks"].shape[1] == 1  # (Le, T, B, ...): the centre frame only
    assert_losses_and_gradients_match(tm, jax_res, port)


def test_pretrain_single_frame_step_vs_jax(pretrain_step):
    tm, jax_res, port = pretrain_step
    assert port["out"]["pred_masks"].shape[1] == 1
    assert_losses_and_gradients_match(tm, jax_res, port)
