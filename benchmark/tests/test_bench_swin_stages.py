"""The readers of the backbone's stage spans (soc.backbone.stage0 and
stage2) on a hand-built trace of two backbone calls: device ms per padded
frame of the kernels launched inside each stage, which with the other two
stages make up the backbone's; nothing on a trace without the stage spans."""
import types

import pytest

from benchmark.spec import metric_reader
from benchmark.tracing import Spans, Trace

from .test_bench_work import chrome

STAGES = ("model.swin_stage0_ms_per_frame", "model.swin_stage2_ms_per_frame")


def backbone(a, bounds):
    """model.backbone_features and soc.backbone from a to bounds[-1], and
    the four stage spans, which end at the given bounds."""
    out = [("model.backbone_features", a, bounds[-1]), ("soc.backbone", a, bounds[-1])]
    for s, b in enumerate(bounds):
        out.append((f"soc.backbone.stage{s}", a, b))
        a = b
    return out


RANGES = [*backbone(0, (100, 150, 300, 320)), ("model.head", 320, 400),
          *backbone(400, (450, 480, 600, 620))]
# (name, device start, duration), launch times: per call stage 0 40 + 30, stage 1 20,
# stage 2 50 + 60 (first) / 50 (second), stage 3 10, one kernel in the head
KERNELS = [("embed", 10, 40), ("wattn_tc_kernel", 60, 30), ("cat", 110, 20),
           ("gemm", 160, 50), ("wattn_tc_kernel", 220, 60), ("layer_norm", 305, 10),
           ("msda_fwd", 330, 50),
           ("embed", 410, 40), ("wattn_tc_kernel", 450, 30), ("cat", 460, 20),
           ("gemm", 490, 50), ("layer_norm", 605, 10)]
LAUNCHES = [5, 20, 105, 155, 210, 301, 325, 405, 420, 455, 485, 601]


def ctx_of(ranges, frames=(16, 8)):
    trace = Trace.from_chrome(chrome(KERNELS, LAUNCHES, ranges, (0, 700)))
    spans = Spans()
    spans.calls["model.backbone_features"] = [{"frames": f} for f in frames]
    return types.SimpleNamespace(trace=trace, spans=spans, busy_s=trace.busy_s(),
                                 window_s=trace.window_s, info={})


def test_stage_readers_on_two_backbone_calls():
    ctx = ctx_of(RANGES)
    got = {name: metric_reader(name)(ctx) for name in STAGES}
    assert got == pytest.approx({
        "model.swin_stage0_ms_per_frame": (40 + 30 + 40 + 30) / 24 * 1e-3,
        "model.swin_stage2_ms_per_frame": (50 + 60 + 50) / 24 * 1e-3})
    whole = metric_reader("model.backbone_ms_per_frame")(ctx)
    stages = sum(ctx.trace.kernel_s(within=f"soc.backbone.stage{s}") for s in range(4))
    assert 1e3 * stages / 24 == pytest.approx(whole)
    assert sum(got.values()) < whole


def test_stage_readers_read_nothing_without_the_stage_spans():
    without = [r for r in RANGES if not r[0].startswith("soc.backbone.stage")]
    for ctx in (ctx_of(without), ctx_of(RANGES, frames=()),
                types.SimpleNamespace(trace=None, spans=Spans())):
        assert {name: metric_reader(name)(ctx) for name in STAGES} == dict.fromkeys(STAGES)
