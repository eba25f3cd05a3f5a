"""The port's InferenceEngine (device="cpu") against the JAX package's, on the
tiny model of tests/test_inference.py with converted parameters, and the
engine's own contracts: multi-expression reuse, bit-packing, and ownership of
the caller's frames."""
import contextlib
import itertools

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


HEAD_PARTS = ("text", "fusion", "encoder", "decoder", "voc", "outputs")


def _inside(child, parents):
    """The parent ranges that hold the child range."""
    return [p for p in parents if p[1] <= child[1] and child[2] <= p[2]]


@pytest.mark.parametrize("t, chunks", [(7, 1), (12, 2)])
def test_spans_of_one_video(engine, monkeypatch, t, chunks):
    """With a profiler recording, one video of two expressions opens the
    engine's and the model's spans, each child inside its parent: per chunk
    an upload, a backbone and a head per expression with its six parts; then
    one finalize, and one collect holding one wait and one unpack. The
    ranges are taken where the spans hand them to torch.profiler (a real
    profiler records some 23,000 events a video of the tiny model, 7 s on
    the CPU; tests/test_torch_spans.py and the CLI and trainer tests cover
    its trace)."""
    ranges, clock = [], itertools.count()

    @contextlib.contextmanager
    def record_function(name):
        r = [name, next(clock), None]
        ranges.append(r)
        yield
        r[2] = next(clock)

    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    engine.infer_video_multi(_video(7, t=t), ["a thing", "another thing"])
    by = {}
    for r in ranges:
        by.setdefault(r[0], []).append(r)
    want = {"soc.engine.dispatch": 1, "soc.engine.upload": chunks, "soc.backbone": chunks,
            "soc.head": 2 * chunks, "soc.engine.finalize": 1, "soc.engine.collect": 1,
            "soc.engine.wait": 1, "soc.engine.unpack": 1,
            **{f"soc.head.{p}": 2 * chunks for p in HEAD_PARTS}}
    assert {k: len(v) for k, v in by.items()} == want
    parent_of = {"soc.engine.upload": "soc.engine.dispatch", "soc.backbone": "soc.engine.dispatch",
                 "soc.head": "soc.engine.dispatch", "soc.engine.finalize": "soc.engine.dispatch",
                 "soc.engine.wait": "soc.engine.collect",
                 "soc.engine.unpack": "soc.engine.collect",
                 **{f"soc.head.{p}": "soc.head" for p in HEAD_PARTS}}
    for child, parent in parent_of.items():
        for r in by[child]:
            assert len(_inside(r, by[parent])) == 1, (child, parent)
    for head in by["soc.head"]:
        assert sorted(r[0] for r in ranges if r[0].startswith("soc.head.")
                      and _inside(r, [head])) == sorted(f"soc.head.{p}" for p in HEAD_PARTS)


def test_no_span_without_a_profiler(engine, monkeypatch):
    """With no profiler recording, a video's dispatch and collect never open
    a record_function range."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    masks = engine.infer_video_multi(_video(8, t=3), ["a thing", "another thing"])
    assert [m.shape for m in masks] == [(3, 40, 56)] * 2
