"""The port's 2D image Swin (VideoSwinBackbone at window (1, 7, 7) with the
per-stage output norms, the `swin-*` backbones) against the benchmark's plain
reference of it.

Small widths (embed 64, heads of 32 channels, every stage with a shifted
block) on 2 frames of 112 x 200: the stage maps 28 x 50, 14 x 25 and 7 x 13
are padded to whole windows and shifted blocks apply the -100 region mask;
the last map, 4 x 7, is no larger than the window, where the port shrinks the
window to the map and drops the shift, as the reference does (the image Swin
pads instead: a departure PERF.md records)."""
import numpy as np
import pytest
import torch
from torch_port_helpers import torch_threads_per_worker  # noqa: F401

from benchmark.reference import video_swin as ref_swin
from neurips2023_soc_torch.convert import seeded_state_dict
from neurips2023_soc_torch.models import video_swin

SMALL = dict(patch_size=(1, 4, 4), embed_dim=64, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16),
             window=(1, 7, 7), out_norms=True, patch_norm=True, drop_path_rate=0.2)


@pytest.fixture(scope="module")
def weights():
    sd = seeded_state_dict(video_swin.VideoSwinBackbone(**SMALL), 7)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_2d_swin_equals_the_reference(weights, attn_impl):
    """Both window-attention paths of the port (pallas runs K3's plain
    version on the CPU) against the reference, f32, on the same seeded
    weights (relative-position tables at a trained table's spread): each of
    the four maps within 1e-4 of its scale."""
    port = video_swin.VideoSwinBackbone(**SMALL, attn_impl=attn_impl).eval()
    ref = ref_swin.VideoSwinBackbone(**SMALL).eval()
    port.load_state_dict(weights, strict=True)
    ref.load_state_dict(weights, strict=True)
    video = torch.from_numpy(np.random.RandomState(3).randn(1, 2, 112, 200, 3).astype(np.float32))
    with torch.no_grad():
        got, want = port(video), ref(video)
    assert [tuple(g.shape) for g in got] == [(2, 28, 50, 64), (2, 14, 25, 128), (2, 7, 13, 256),
                                            (2, 4, 7, 512)]
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
