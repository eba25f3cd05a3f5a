"""The readers of the program's own spans (soc.*) on a hand-built trace of two
videos: host ms per video of the upload, the wait and the unpack, host ms and
device operations per head call, and the card's idle per head call, whose
sum with the idle under every other span is the window's idle."""
import types

import pytest

from benchmark.spec import metric_reader
from benchmark.tracing import Spans, Trace

from .test_bench_work import chrome

PARTS = ("text", "fusion", "encoder", "decoder", "voc", "outputs")
NEW = ("engine.upload_ms", "engine.wait_ms", "engine.unpack_ms", "model.head_host_ms",
       "model.head_launches", "model.head_idle_ms")


def head(a, bounds):
    """A soc.head range from a to bounds[-1] and its six parts, which end at
    the given bounds."""
    out = [("soc.head", a, bounds[-1])]
    for part, b in zip(PARTS, bounds):
        out.append((f"soc.head.{part}", a, b))
        a = b
    return out


RANGES = [  # microseconds; window 0-1000
    ("soc.engine.dispatch", 0, 400), ("soc.engine.upload", 10, 40),
    ("soc.backbone", 40, 100),
    *head(100, (130, 160, 200, 220, 235, 250)), *head(250, (270, 300, 330, 350, 370, 390)),
    ("soc.engine.finalize", 390, 400),
    ("soc.engine.collect", 400, 520), ("soc.engine.wait", 400, 480),
    ("soc.engine.unpack", 480, 520),
    ("soc.engine.dispatch", 520, 700), ("soc.engine.upload", 520, 540),
    ("soc.engine.upload", 540, 560), ("soc.backbone", 560, 600),
    *head(600, (610, 630, 650, 660, 670, 690)), ("soc.engine.finalize", 690, 700),
    ("soc.engine.collect", 700, 900), ("soc.engine.wait", 700, 850),
    ("soc.engine.unpack", 850, 900),
]
# (name, device start, duration) and launch times: busy 490 of the 1000, idle
# gaps 0-20, 150-180, 190-260, 320-330, 340-395, 470-530, 560-620, 645-700,
# 850-1000; the head's: 150-180 (encoder), 190-260 (voc) of the first head,
# 320-330 (encoder), 340-395 (voc) of the second, 645-700 (outputs) of the third
KERNELS = [("copy", 20, 40), ("swin", 60, 80), ("embed", 140, 10), ("proj", 180, 10),
           ("msda_fwd", 260, 40), ("embed", 300, 20), ("msda_fwd", 330, 10),
           ("resize", 395, 75), ("copy", 530, 30), ("proj", 620, 25), ("mask", 700, 100),
           ("copy", 800, 50)]
LAUNCHES = [15, 45, 105, 170, 210, 260, 320, 395, 530, 610, 675, 710]


def ctx_of(ranges, kernels=KERNELS, launches=LAUNCHES):
    trace = Trace.from_chrome(chrome(kernels, launches, ranges, (0, 1000)))
    return types.SimpleNamespace(trace=trace, spans=Spans(), busy_s=trace.busy_s(),
                                 window_s=trace.window_s, info={})


def test_span_readers_on_two_videos():
    ctx = ctx_of(RANGES)
    got = {name: metric_reader(name)(ctx) for name in NEW}
    assert got == pytest.approx({
        "engine.upload_ms": (30 + 20 + 20) / 2 * 1e-3,
        "engine.wait_ms": (80 + 150) / 2 * 1e-3,
        "engine.unpack_ms": (40 + 50) / 2 * 1e-3,
        "model.head_host_ms": (150 + 140 + 90) / 3 * 1e-3,
        "model.head_launches": (3 + 2 + 2) / 3,
        "model.head_idle_ms": (30 + 70 + 10 + 55 + 55) / 3 * 1e-3})


def test_head_idle_and_the_rest_make_the_window_idle():
    ctx = ctx_of(RANGES)
    heads = sum(n == "soc.head" for n, _, _ in RANGES)
    head_idle = metric_reader("model.head_idle_ms")(ctx) * 1e-3 * heads
    gaps = dict(ctx.trace.idle_gaps(n=100))
    in_head = sum(v for k, v in gaps.items() if k == "soc.head" or k.startswith("soc.head."))
    elsewhere = sum(v for k, v in gaps.items() if k not in ("soc.head",)
                    and not k.startswith("soc.head."))
    assert head_idle == pytest.approx(in_head)
    assert head_idle + elsewhere == pytest.approx(ctx.window_s - ctx.busy_s)
    assert ctx.window_s - ctx.busy_s == pytest.approx(510e-6)
    assert gaps["host outside the spans"] == pytest.approx(150e-6)


def test_span_readers_read_nothing_without_the_spans():
    outside = [("model.head", 100, 250), ("engine.collect", 400, 520)]  # a tree without soc.*
    for ctx in (ctx_of(outside), types.SimpleNamespace(trace=None, spans=Spans())):
        assert {name: metric_reader(name)(ctx) for name in NEW} == dict.fromkeys(NEW)
