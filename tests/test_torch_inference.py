"""The port's InferenceEngine (device="cpu") against the JAX package's, on the
tiny model of tests/test_inference.py with converted parameters, and the
engine's own contracts: multi-expression reuse, bit-packing, ownership of
the caller's frames, and the worker thread that unpacks each video."""
import contextlib
import gc
import itertools
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from neurips2023_soc_tpu.inference import InferenceEngine as JaxEngine
from neurips2023_soc_tpu.models.soc import SOC as JaxSOC
from neurips2023_soc_torch import inference
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


@pytest.fixture(scope="module")
def jax_engines(models):
    """The JAX package's engine for a tuple of time buckets, built once a
    module so that its programs compile once."""
    jm, params, _ = models
    built = {}

    def get(buckets):
        if buckets not in built:
            built[buckets] = JaxEngine(jm, params, time_buckets=buckets, **ENGINE)
        return built[buckets]
    return get


def _agreement(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return float((a == b).mean())


def test_engine_matches_jax_single_chunk(models, jax_engines):
    jm, params, tm = models
    frames, text = _video(0), "a thing on the left"
    jeng = jax_engines((4, 8))
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
    assert int(_extract_outputs(tout)[0][:7, 0].sum(0).argmax()) == jq

    jmask, jbox = jeng.infer_video(frames, text, original_size=ORIGINAL, return_boxes=True)
    tmask, tbox = teng.infer_video(frames, text, original_size=ORIGINAL, return_boxes=True)
    assert tmask.shape == (7,) + ORIGINAL
    assert set(np.unique(tmask).tolist()) <= {0, 1}
    assert _agreement(tmask, jmask) >= 0.999
    np.testing.assert_allclose(tbox, jbox, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("trajectory", ["video", "chunk"])
def test_engine_matches_jax_chunked(models, jax_engines, trajectory):
    """7 frames over 4-frame buckets: two chunks, one trajectory for the
    whole video (score sums across chunks) or one per chunk."""
    jm, params, tm = models
    frames, text = _video(1), "another thing"
    jeng = jax_engines((4,))
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


# The port's batched rows against its own B = 1 rows on the CPU: the GEMMs
# pick their kernel by the number of rows, so a row's f32 sums change in the
# last bits, and where that rounds a bf16 mask logit one step the other way
# (two where the sum cancels), the two bilinear resizes and the sigmoid carry
# it into the probabilities. Largest read over the four cases below: 2.14e-3.
B1_PROB_ATOL = 5e-3


@pytest.mark.parametrize("buckets, trajectory, head_rows, texts, chunks, calls", [
    ((4, 8), "video", None, ["a thing", "another longer thing"], 1, 1),
    ((4,), "video", None, ["a thing", "another longer thing"], 2, 2),
    ((4,), "chunk", None, ["a thing", "another longer thing"], 2, 2),
    ((4, 8), "video", 16, ["a thing", "another longer thing", "a dog on the left"], 1, 2),
], ids=["one_chunk", "two_chunks_video", "two_chunks_chunk", "group_split"])
def test_multi_expression_equals_per_expression(models, jax_engines, monkeypatch, buckets,
                                                trajectory, head_rows, texts, chunks, calls):
    """The expressions of a video share a head call per chunk (B = the
    group's size): one chunk, two chunks under either trajectory, and three
    texts split 2 + 1 by a small HEAD_ROWS. Each expression's masks and
    boxes hold against the JAX engine's infer_video_multi on the same texts,
    at the single-text tests' bounds. Against the port's B = 1 (infer_video
    per text) the masks are equal, the boxes agree to f32 rounding and the
    probabilities within B1_PROB_ATOL. Its probabilities and boxes are, bit
    for bit, those of its text in every row of a group of the same shape, so
    no row of a head call reads another row's expression."""
    if head_rows is not None:
        monkeypatch.setattr(inference, "HEAD_ROWS", head_rows)
    engine = InferenceEngine(models[2], time_buckets=buckets, device="cpu", **ENGINE)
    frames = _video(2)
    kw = dict(original_size=ORIGINAL, trajectory=trajectory, return_boxes=True)
    multi = engine.infer_video_multi(frames, texts, return_probs=True, **kw)
    assert (engine.head_calls, engine.head_expressions) == (calls, chunks * len(texts))
    masks = engine.infer_video_multi(frames, texts, **kw)
    jax = jax_engines(buckets).infer_video_multi(frames, texts, **kw)
    for i, text in enumerate(texts):
        assert _agreement(masks[i][0], jax[i][0]) >= 0.999
        np.testing.assert_allclose(masks[i][1], jax[i][1], rtol=1e-4, atol=1e-3)
        one_mask, one_box = engine.infer_video(frames, text, **kw)
        np.testing.assert_array_equal(masks[i][0], one_mask)
        np.testing.assert_allclose(masks[i][1], one_box, rtol=1e-5, atol=1e-4)
        one_probs = engine.infer_video(frames, text, return_probs=True, **kw)[0]
        np.testing.assert_allclose(multi[i][0], one_probs, rtol=0, atol=B1_PROB_ATOL)
        same = engine.infer_video_multi(frames, [text] * len(texts), return_probs=True,
                                        **kw)[i]
        np.testing.assert_array_equal(multi[i][0], same[0])
        np.testing.assert_array_equal(multi[i][1], same[1])
    assert np.abs(multi[0][0] - multi[1][0]).max() > 1e-6


@pytest.mark.parametrize("head_rows, calls", [(None, 1), (16, 2), (4, 3)])
def test_head_counters(models, monkeypatch, head_rows, calls):
    """A 7-frame video of three texts over buckets (4, 8) is one chunk of
    T = 8: one head call for the three, or groups of HEAD_ROWS // 8 (at least
    one)."""
    if head_rows is not None:
        monkeypatch.setattr(inference, "HEAD_ROWS", head_rows)
    engine = InferenceEngine(models[2], time_buckets=(4, 8), device="cpu", **ENGINE)
    engine.infer_video_multi(_video(9), ["a thing", "another thing", "a dog"])
    assert (engine.head_calls, engine.head_expressions) == (calls, 3)


def test_head_groups_follow_the_bucket():
    """Groups of HEAD_ROWS // T consecutive expressions: the cell's 8
    expressions at T = 64 split 4 + 4, at T = 32 share one call."""
    assert inference.head_groups(8, 64) == [range(0, 4), range(4, 8)]
    assert inference.head_groups(8, 32) == [range(0, 8)]
    assert inference.head_groups(5, 64) == [range(0, 4), range(4, 5)]
    assert inference.head_groups(2, 512) == [range(0, 1), range(1, 2)]


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


def _parts(result):
    return result if isinstance(result, tuple) else (result,)


@pytest.mark.parametrize("pack_masks, probs_dtype, kw", [
    (True, "float32", {}),
    (False, "float32", {}),
    (True, "float32", dict(return_probs=True)),
    (True, "uint8", dict(return_probs=True)),
    (True, "float32", dict(return_boxes=True)),
], ids=["packed", "unpacked", "probs_f32", "probs_u8", "boxes"])
def test_pipelined_videos_equal_one_at_a_time(models, pack_masks, probs_dtype, kw):
    """infer_videos at depth 1 over three videos, the second of two chunks:
    the collector thread unpacks video i while video i+1 is dispatched, and
    each video's results equal infer_video_multi's on it, bit for bit and
    dtype for dtype. Each video is collected once."""
    engine = InferenceEngine(models[2], time_buckets=(4, 8), pack_masks=pack_masks,
                             probs_dtype=probs_dtype, device="cpu", **ENGINE)
    items = [dict(frames=_video(10, t=5), texts=["a thing"], original_size=ORIGINAL, **kw),
             dict(frames=_video(11, t=12), texts=["a thing", "another thing"], **kw),
             dict(frames=_video(12), texts=["a dog", "a cat", "a thing"],
                  original_size=(41, 59), **kw)]
    got = list(engine.infer_videos(iter(items), depth=1))
    assert engine.collects == 3 and 0 <= engine.collects_ready <= 3
    for res, item in zip(got, items):
        want = engine.infer_video_multi(**item)
        assert len(res) == len(want) == len(item["texts"])
        for a, b in zip(res, want):
            assert len(_parts(a)) == len(_parts(b)) == 1 + bool(kw.get("return_boxes"))
            for x, y in zip(_parts(a), _parts(b)):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)


def test_collector_error_reaches_the_caller(models, monkeypatch):
    """An exception in the collector's unpack of the second of three
    pipelined videos is raised by infer_videos at that video's result,
    after the first video's; the engine then serves the next video as
    before."""
    engine = InferenceEngine(models[2], time_buckets=(4, 8), device="cpu", **ENGINE)
    videos = [_video(13), _video(14), _video(15)]
    want = [engine.infer_video(v, "a thing") for v in videos]
    unpack, calls = inference._unpack, itertools.count()

    def failing(handle):
        if next(calls) == 1:
            raise RuntimeError("unpack failed")
        return unpack(handle)

    monkeypatch.setattr(inference, "_unpack", failing)
    results = engine.infer_videos(dict(frames=v, texts=["a thing"]) for v in videos)
    np.testing.assert_array_equal(next(results)[0], want[0])
    with pytest.raises(RuntimeError, match="unpack failed"):
        next(results)
    np.testing.assert_array_equal(engine.infer_video(videos[2], "a thing"), want[2])


def _collector_threads():
    return {t for t in threading.enumerate() if t.name.startswith("soc-engine-collector")}


def test_collector_thread_is_a_daemon_and_ends_with_its_engine(models):
    """The engine's worker thread (no longer a daemon: at interpreter exit
    Python finishes its queued collects) starts on the first dispatch, and
    ends once its engine is collected."""
    before = _collector_threads()
    engine = InferenceEngine(models[2], time_buckets=(4, 8), device="cpu", **ENGINE)
    assert _collector_threads() == before
    engine.infer_video(_video(16, t=3), "a thing")
    (thread,) = _collector_threads() - before
    assert thread.is_alive()
    del engine
    gc.collect()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_collector_keeps_each_video_its_own_result(engine):
    """Stress: 200 hand-made videos of packed masks go through one engine's
    worker while the interpreter switches threads every microsecond, the
    caller collecting each three videos behind its hand-off; every collect
    returns its own video's bits, cropped to its width."""
    rng = np.random.RandomState(17)
    packed = [rng.randint(0, 256, (2, 3, 4), dtype=np.uint8) for _ in range(200)]
    handles, got = [], []
    calls, ready = engine.collects, engine.collects_ready
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for i, p in enumerate(packed):
            handles.append(dict(results=[(torch.from_numpy(p), None)], event=None, oh=3,
                                ow=25 + i % 8, pack=True, return_probs=False,
                                return_boxes=False))
            engine._submit(handles[-1])
            if i >= 3:
                assert handles[i - 3]["future"].exception(timeout=10) is None
                got.append(engine._collect_video(handles[i - 3]))
        for h in handles[-3:]:
            assert h["future"].exception(timeout=10) is None
            got.append(engine._collect_video(h))
    finally:
        sys.setswitchinterval(interval)
    assert engine.collects - calls == 200 and engine.collects_ready - ready == 200
    for i, (p, (m,)) in enumerate(zip(packed, got)):
        np.testing.assert_array_equal(m, np.unpackbits(p, axis=-1)[:, :, :25 + i % 8])


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
    an upload, a backbone with its four stages and one head for both
    expressions with its six parts; then one finalize, and one collect holding one wait and one unpack. The
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
            "soc.head": chunks, "soc.engine.finalize": 1, "soc.engine.collect": 1,
            "soc.engine.wait": 1, "soc.engine.unpack": 1,
            **{f"soc.head.{p}": chunks for p in HEAD_PARTS},
            **{f"soc.backbone.stage{s}": chunks for s in range(4)}}
    assert {k: len(v) for k, v in by.items()} == want
    parent_of = {"soc.engine.upload": "soc.engine.dispatch", "soc.backbone": "soc.engine.dispatch",
                 "soc.head": "soc.engine.dispatch", "soc.engine.finalize": "soc.engine.dispatch",
                 "soc.engine.wait": "soc.engine.collect",
                 "soc.engine.unpack": "soc.engine.collect",
                 **{f"soc.head.{p}": "soc.head" for p in HEAD_PARTS},
                 **{f"soc.backbone.stage{s}": "soc.backbone" for s in range(4)}}
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
