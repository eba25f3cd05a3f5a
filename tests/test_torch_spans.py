"""utils/logging.py:span, the program's named ranges in a torch.profiler
trace: a shared no-op with no profiler recording, a closed range when the
code inside raises, the backbone's four stage spans inside soc.backbone, and
(on the card) a dispatch whose spans and head hold no hidden host sync, and
the engine's worker thread against a synchronous unpack. Imports no JAX (nor tests/torch_port_helpers.py, which does), so the card
test runs where JAX is absent; its CPU tests do no torch-heavy work, so they
take no thread share under xdist."""
import time
from collections import deque

import numpy as np
import pytest
import torch

from neurips2023_soc_torch import inference
from neurips2023_soc_torch.inference import InferenceEngine
from neurips2023_soc_torch.models.common import init_weights
from neurips2023_soc_torch.models.soc import SOC
from neurips2023_soc_torch.utils.logging import span

KW = dict(backbone_name="video-swin-t", d_model=64, num_queries=5, dim_feedforward=128,
          enc_layers=1, dec_layers=2, voc_enc_layers=1, voc_dec_layers=1,
          text_encoder_type="roberta-tiny")
ENGINE = dict(text_encoder_type="roberta-tiny", text_bucket=8, size_buckets=((48, 64),),
              time_buckets=(4, 8))


def test_span_without_a_profiler_is_one_shared_no_op():
    assert span("soc.a") is span("soc.b")
    with span("soc.a"):
        pass


def test_span_closes_its_range_when_the_code_raises():
    """Under a profiler an exception inside a span propagates, and the
    profiler's trace holds the span's range closed before what ran next."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError, match="inside the span"):
            with span("soc.test.outer"):
                with span("soc.test.inner"):
                    torch.ones(4).add_(1)
                    raise ValueError("inside the span")
        torch.ones(4).mul_(2)
    events = prof.events()
    ranges = {e.name: e.time_range for e in events if e.name.startswith("soc.test.")}
    assert set(ranges) == {"soc.test.outer", "soc.test.inner"}
    outer, inner = ranges["soc.test.outer"], ranges["soc.test.inner"]
    assert outer.start <= inner.start <= inner.end <= outer.end
    after = [e.time_range.start for e in events if e.name == "aten::mul_"]
    assert after and outer.end <= min(after)


@pytest.mark.parametrize("backbone", ["video-swin-t", "swin-t"])
def test_stage_spans_partition_the_backbone(backbone):
    """Under torch.profiler one backbone call of the tiny model (3D and 2D
    Swin) opens soc.backbone.stage0 to stage3 once each, one after another,
    inside soc.backbone."""
    model = init_weights(SOC(**dict(KW, backbone_name=backbone)),
                         torch.Generator().manual_seed(0)).eval()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.backbone_features(torch.zeros(2, 1, 32, 32, 3))
    ranges = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                    if e.name.startswith("soc.backbone"))
    assert [n for _, _, n in ranges] == ["soc.backbone"] + [f"soc.backbone.stage{s}"
                                                           for s in range(4)]
    (a, b, _), stages = ranges[0], ranges[1:]
    assert all(a <= s0 <= s1 <= b for s0, s1, _ in stages)
    assert all(stages[i][1] <= stages[i + 1][0] for i in range(3))


@pytest.mark.card
def test_dispatch_holds_no_hidden_host_sync():
    """A warm dispatch of the tiny model on the card, under
    torch.cuda.set_sync_debug_mode("error"): the upload, the backbone, the
    head of both texts in one call and the finalize queue their work without
    a host sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card)")
    model = init_weights(SOC(**KW), torch.Generator().manual_seed(0)).eval()
    engine = InferenceEngine(model, device="cuda", **ENGINE)
    frames = np.random.RandomState(0).randint(0, 256, (7, 40, 56, 3)).astype(np.uint8)
    texts = ["a thing", "another thing"]
    engine.infer_video_multi(frames, texts)  # builds the kernels, fills the caches
    torch.cuda.synchronize()
    calls = engine.head_calls
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = engine._dispatch_video(frames, texts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    masks = engine._collect_video(handle)
    assert [m.shape for m in masks] == [(7, 40, 56)] * 2
    assert engine.head_calls - calls == 1


@pytest.mark.card
def test_collector_equals_a_synchronous_unpack():
    """Four videos of 2-5 expressions at 360 x 640 (720 x 1280 originals),
    dispatched and collected at depth 1 on the card: the collector's results
    (packed masks with boxes, one video's bfloat16 probabilities) equal, bit
    for bit, an unpack on this thread of the same handles after their event.
    While the collector waits on an event behind 0.2 s or more of card work,
    this thread keeps running Python (the wait releases the interpreter
    lock). Prints the collect counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card)")
    model = init_weights(SOC(**KW), torch.Generator().manual_seed(0)).eval()
    engine = InferenceEngine(model, device="cuda", probs_dtype="bfloat16",
                             **dict(ENGINE, size_buckets=((360, 640),), time_buckets=(8, 16, 32)))
    rng = np.random.RandomState(1)
    items = [dict(frames=rng.randint(0, 256, (t, 360, 640, 3)).astype(np.uint8),
                  texts=[f"thing number {k}" for k in range(n)], original_size=(720, 1280),
                  return_boxes=True) for t, n in ((12, 3), (20, 5), (9, 2), (31, 4))]
    items[2]["return_probs"] = True
    for _ in engine.infer_videos(iter(items), depth=1):  # fills the caches
        pass
    torch.cuda.synchronize()
    calls, ready = engine.collects, engine.collects_ready
    handles, got, pending = [], [], deque()
    for item in items:
        pending.append(engine._dispatch_video(**item))
        handles.append(pending[-1])
        if len(pending) > 1:
            got.append(engine._collect_video(pending.popleft()))
    got.append(engine._collect_video(pending.popleft()))
    print(f"collects {engine.collects - calls}, ready {engine.collects_ready - ready}")
    assert engine.collects - calls == 4
    for h, res in zip(handles, got):
        h["event"].synchronize()
        want = inference._unpack(h)
        assert len(res) == len(want) == len(h["results"])
        for (m, b), (wm, wb) in zip(res, want):
            assert m.dtype == wm.dtype and m.shape == wm.shape
            np.testing.assert_array_equal(m, wm)
            np.testing.assert_array_equal(b, wb)

    def python_ms():
        t0 = time.perf_counter()
        sum(i * i for i in range(200_000))
        return 1e3 * (time.perf_counter() - t0)

    alone = min(python_ms() for _ in range(3))
    torch.cuda._sleep(int(1e9))  # about half a second of one SM
    handle = dict(results=[], event=torch.cuda.Event(), oh=720, ow=1280, pack=True,
                  return_probs=False, return_boxes=False)
    handle["event"].record()
    engine._submit(handle)
    waiting = python_ms()
    assert not handle["seen"].is_set(), "the card finished before the check"
    print(f"python ms alone {alone:.2f}, while the collector waits {waiting:.2f}")
    assert waiting < 3 * alone + 50
    assert engine._collect_video(handle) == []
