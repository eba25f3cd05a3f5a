"""The port's InferenceEngine (device="cpu") against the JAX package's, on the
tiny model of tests/test_inference.py with converted parameters, and the
engine's own contracts: multi-expression reuse, bit-packing, and ownership of
the caller's frames."""
import jax
import numpy as np
import pytest
import torch

from neurips2023_soc_tpu.inference import InferenceEngine as JaxEngine
from neurips2023_soc_tpu.models.soc import SOC as JaxSOC
from neurips2023_soc_torch.convert import load_jax_params
from neurips2023_soc_torch.inference import (InferenceEngine, _extract_outputs,
                                             _normalize_u8_in_graph)
from neurips2023_soc_torch.models.soc import SOC
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)

KW = dict(backbone_name="video-swin-t", d_model=64, num_queries=5, dim_feedforward=128,
          enc_layers=1, dec_layers=2, voc_enc_layers=1, voc_dec_layers=1,
          text_encoder_type="roberta-tiny")
ENGINE = dict(text_encoder_type="roberta-tiny", text_bucket=8, size_buckets=((48, 64),))
ORIGINAL = (80, 112)  # the frames' size before the 40 x 56 resize


def _video(seed, t=7):
    """uint8 frames smaller than the 48 x 64 bucket, smooth enough that the
    masks are not noise."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (t, 10, 14, 3)).astype(np.float32)
    frames = np.kron(base, np.ones((1, 4, 4, 1), np.float32))
    return np.clip(frames + rng.randn(*frames.shape) * 8, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def models():
    jm = JaxSOC(dropout=0.0, **KW)
    px = np.zeros((4, 1, 48, 64, 3), np.float32)
    pad = np.zeros((4, 1, 48, 64), bool)
    ids = np.ones((1, 8), np.int32)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), px, pad, ids, ids))
    return jm, params, load_jax_params(SOC(**KW), params).eval()


def _agreement(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return float((a == b).mean())


def test_engine_matches_jax_single_chunk(models):
    jm, params, tm = models
    frames, text = _video(0), "a thing on the left"
    jeng = JaxEngine(jm, params, time_buckets=(4, 8), **ENGINE)
    teng = InferenceEngine(tm, time_buckets=(4, 8), device="cpu", **ENGINE)

    # the same chosen query: the JAX engine's in-graph selection against the
    # argmax of the port's summed per-query scores
    jpx = jeng._pixel_buffer(frames, 8, 48, 64, 40, 56, "u8", None)
    jpad = jeng._get_pad(8, 48, 64, 40, 56, None)
    ids, msk = jeng.tokenizer([text])
    jq = int(jeng._get_sel_program("u8")(params, jpx, jpad, ids, msk, np.int32(7))[1])
    tpad = teng._get_pad(8, 48, 64, 40, 56)
    tpx = _normalize_u8_in_graph(teng._pixel_buffer(frames, 8, 48, 64, 40, 56), tpad,
                                 teng._mean, teng._std)
    with torch.no_grad():
        tout = tm(tpx, tpad, *(torch.from_numpy(a) for a in (ids, msk)))
    assert int(_extract_outputs(tout)[0][:7].sum(0).argmax()) == jq

    jmask, jbox = jeng.infer_video(frames, text, original_size=ORIGINAL, return_boxes=True)
    tmask, tbox = teng.infer_video(frames, text, original_size=ORIGINAL, return_boxes=True)
    assert tmask.shape == (7,) + ORIGINAL
    assert set(np.unique(tmask).tolist()) <= {0, 1}
    assert _agreement(tmask, jmask) >= 0.999
    np.testing.assert_allclose(tbox, jbox, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("trajectory", ["video", "chunk"])
def test_engine_matches_jax_chunked(models, trajectory):
    """7 frames over 4-frame buckets: two chunks, one trajectory for the
    whole video (score sums across chunks) or one per chunk."""
    jm, params, tm = models
    frames, text = _video(1), "another thing"
    jeng = JaxEngine(jm, params, time_buckets=(4,), **ENGINE)
    teng = InferenceEngine(tm, time_buckets=(4,), device="cpu", **ENGINE)
    jmask, jbox = jeng.infer_video(frames, text, original_size=ORIGINAL,
                                   trajectory=trajectory, return_boxes=True)
    tmask, tbox = teng.infer_video(frames, text, original_size=ORIGINAL,
                                   trajectory=trajectory, return_boxes=True)
    assert _agreement(tmask, jmask) >= 0.999
    np.testing.assert_allclose(tbox, jbox, rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module")
def engine(models):
    return InferenceEngine(models[2], time_buckets=(4, 8), device="cpu", **ENGINE)


def test_multi_expression_equals_per_expression(engine):
    frames = _video(2)
    texts = ["a thing", "another longer thing"]
    multi = engine.infer_video_multi(frames, texts, original_size=ORIGINAL,
                                     return_probs=True)
    for text, got in zip(texts, multi):
        want = engine.infer_video(frames, text, original_size=ORIGINAL, return_probs=True)
        np.testing.assert_array_equal(got, want)
    assert np.abs(multi[0] - multi[1]).max() > 1e-6


def test_packed_and_unpacked_masks_identical(models, engine):
    frames = _video(3)
    unpacked = InferenceEngine(models[2], time_buckets=(4, 8), pack_masks=False,
                               device="cpu", **ENGINE)
    for size in (ORIGINAL, (41, 59)):  # widths a multiple of 8 and not
        a = engine.infer_video(frames, "a thing", original_size=size)
        b = unpacked.infer_video(frames, "a thing", original_size=size)
        assert a.shape == (7,) + size
        np.testing.assert_array_equal(a, b)


def test_caller_may_reuse_frames_after_dispatch(engine):
    """infer_videos dispatches video i+1 before it returns video i; the
    engine copies each video's frames, so a caller that overwrites its array
    right after a dispatch changes no result."""
    videos = [_video(4), _video(5)]
    want = [engine.infer_video(v, "a thing") for v in videos]
    shared = np.empty_like(videos[0])  # one buffer the caller refills

    def items():
        for v in videos:
            shared[...] = v
            yield dict(frames=shared, texts=["a thing"])
            shared[...] = 0  # the caller reuses its buffer at once

    got = [r[0] for r in engine.infer_videos(items(), depth=1)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_pixel_buffer_never_aliases_the_frames(engine):
    frames = np.random.RandomState(6).randint(0, 256, (8, 48, 64, 3)).astype(np.uint8)
    buf = engine._pixel_buffer(frames, 8, 48, 64, 48, 64)  # exact bucket fit
    assert not np.shares_memory(buf.numpy(), frames)
    np.testing.assert_array_equal(buf.numpy()[:, 0], frames)
