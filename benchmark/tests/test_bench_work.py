"""Operations and bytes from shapes, the model counter, and the arithmetic
of the readers on a synthetic trace."""
import json
import math
import statistics
import types
from pathlib import Path

import pytest

from benchmark import readers
from benchmark.tracing import Spans, Trace
from benchmark.work import kernels
from benchmark.work.model import ModelWork

REPO = Path(__file__).resolve().parents[2]


def test_kernel_bounds_reproduce_the_table():
    # PERF.md's kernel table: K1 at value (16, 4820, 8, 32) bf16, K2 at (8, 4820, 8, 32),
    # K3 at stage 3 masked (48, 16, 392, 32) bf16, all at 3.35 TB/s (bytes-bound)
    S = 45 * 80 + 23 * 40 + 12 * 20 + 6 * 10
    k1 = kernels.msda_fwd(16, S, 8, 32, S, 4, 4, 2, 2)
    k2 = kernels.msda_bwd(8, S, 8, 32, S, 4, 4, 2, 2)
    k3 = kernels.window_attention(48, 16, 392, 32, 2, masked_windows=48)
    assert round(k1 * 1e3, 4) == 0.0530
    assert round(k2 * 1e3, 4) == 0.0471
    assert round(k3 * 1e3, 4) == 0.0260


def swin_hand_count(T, H, W, embed=128, depths=(2, 2, 18, 2), win=(8, 7, 7)):
    """Video-Swin FLOPs (2 per multiply-add): patch embedding; per block the
    qkv and output projections over the window-padded tokens, q.k and p.v over
    each window's N tokens, the MLP (ratio 4) over the real tokens; the patch
    merging linears."""
    h, w = math.ceil(H / 4), math.ceil(W / 4)
    flops = 2 * T * h * w * 48 * embed
    C = embed
    for s, depth in enumerate(depths):
        wd, wh, ww = min(win[0], T), min(win[1], h), min(win[2], w)
        N = wd * wh * ww
        padded = (math.ceil(T / wd) * wd) * (math.ceil(h / wh) * wh) * (math.ceil(w / ww) * ww)
        flops += depth * 2 * (padded * 4 * C * C + padded * 2 * N * C + T * h * w * 8 * C * C)
        if s < 3:
            h, w = math.ceil(h / 2), math.ceil(w / 2)
            flops += 2 * T * h * w * 4 * C * 2 * C
            C *= 2
    return flops


def test_model_counter_matches_the_hand_count_of_swin_b():
    cfg = json.loads((REPO / "benchmark/configs/soc-vswin-b-ytvos.json").read_text())
    backbone, head = ModelWork(cfg).inference(16, 360, 640)
    assert backbone == swin_hand_count(16, 360, 640) == 2_884_918_181_888
    assert 0 < head < backbone


def chrome(kernels_, launches, ranges, window):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": window[0], "dur": window[1] - window[0]}]
    for i, (name, ts, dur) in enumerate(kernels_):
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
                   "args": {"correlation": i}})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": launches[i], "dur": 1, "args": {"correlation": i}})
    for name, a, b in ranges:
        ev.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": a, "dur": b - a})
    return {"traceEvents": ev}


@pytest.fixture
def trace():
    # microseconds: window 0-100; kernels overlap at 20-30 (union 10-40), a gap 40-70
    ks = [("msda_fwd_vec_kernel", 10, 20), ("gemm", 20, 20), ("wattn_tc_kernel", 70, 10)]
    return Trace.from_chrome(chrome(ks, [5, 6, 60], [("model.head", 0, 8),
                                                      ("engine.collect", 30, 90)], (0, 100)))


def test_busy_idle_and_overlap(trace):
    assert trace.window_s == pytest.approx(100e-6)
    assert trace.busy_s() == pytest.approx(40e-6)  # 10-40 and 70-80, overlap counted once
    ctx = types.SimpleNamespace(trace=trace, busy_s=trace.busy_s(), window_s=trace.window_s,
                                info={"model_flops": 989e12 * 50e-6}, spans=Spans())
    assert readers.idle(ctx) == pytest.approx(60.0)
    assert readers.mfu(ctx) == pytest.approx(50.0)


def test_kernels_by_name_and_by_launching_range(trace):
    assert trace.kernel_s("msda_fwd") == pytest.approx(20e-6)
    assert trace.kernel_s(within="model.head") == pytest.approx(40e-6)  # launched at 5 and 6
    assert trace.kernel_s(within="engine.collect") == pytest.approx(10e-6)
    assert trace.top_ops(2)[0][0] in ("msda_fwd_vec_kernel", "gemm")
    gaps = dict(trace.idle_gaps())
    assert gaps["engine.collect"] == pytest.approx(50e-6)  # 40-70 and 80-100
    assert gaps["model.head"] == pytest.approx(10e-6)  # 0-10


def test_roofline_is_least_time_over_kernel_time(trace):
    spans = Spans()
    spans.calls["k1.call"].append({"x": 1})
    ctx = types.SimpleNamespace(trace=trace, spans=spans)
    assert readers.roofline(ctx, "k1.call", "msda_fwd", lambda x: 5e-6) == pytest.approx(25.0)
    assert readers.roofline(ctx, "k1.call", "msda_bwd", lambda x: 5e-6) is None
    assert readers.roofline(types.SimpleNamespace(trace=None, spans=spans), "k1.call",
                            "msda_fwd", lambda x: 1.0) is None


class FakeEngine:
    """infer_videos at depth 1 where each video takes `cost` seconds."""

    def __init__(self, cost, clock):
        self.cost, self.clock = cost, clock

    def infer_videos(self, items, depth=1):
        for item in items:
            self.clock[0] += self.cost * item["frames"].shape[0]
            yield [None] * len(item["texts"])


def test_engine_rates_are_all_work_over_the_window(monkeypatch):
    from benchmark.drivers import engine
    from benchmark.traffic.videos import Videos

    mix = json.loads((REPO / "benchmark/tests/fixtures/tiny_videos.json").read_text())
    clock = [0.0]
    monkeypatch.setattr(engine.time, "perf_counter", lambda: clock[0])
    st = engine.State()
    st.mix, st.engine = mix, FakeEngine(0.1, clock)
    st.videos, st.sample, st.results = Videos(mix, 5, "cpu"), [], {}
    out = engine.window(st, 4.0)
    done = out["in_window"]
    assert all(r["t1"] <= 4.0 for r in done)
    assert out["e2e"]["masks_per_s"] == pytest.approx(
        sum(r["frames"] * r["n_expr"] for r in done) / 4.0)
    lat = [1e3 * (r["t1"] - r["t0"]) for r in done]
    assert out["e2e"]["video_p90_ms"] == pytest.approx(
        statistics.quantiles(lat, n=10, method="inclusive")[8])
    assert out["failed"] == 0 and out["attempted"] >= len(done) > 0
