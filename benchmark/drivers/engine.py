"""Engine cells: videos in a closed loop through
InferenceEngine.infer_videos at pipeline depth 1, the loop
cli/infer_refytb.py runs on one card.

A video's latency runs from the moment the engine takes it from the loop
until its last mask is on the host, so it includes the wait behind the video
ahead. Masks count the real frames times the expressions of each video done
in the window; bucket padding counts for nothing.
"""
from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from .. import correct
from ..reference import build_reference, plain_float32
from ..reference.engine import reference_video
from ..spec import generator
from ..weights import make_weights


class State:
    pass


def build_program(cfg: Dict, seed: int, device):
    from neurips2023_soc_torch.config import Config
    from neurips2023_soc_torch.models import build_model

    model = build_model(Config(cfg), device=device)
    model.load_state_dict(make_weights(cfg, seed, device), strict=True)
    return model.eval()


def setup(cell: Dict, seed: int, device) -> State:
    from neurips2023_soc_torch.inference import InferenceEngine

    st = State()
    st.cell, st.seed, st.device = cell, seed, device
    cfg, mix = cell["config_data"], cell["traffic_data"]
    st.cfg, st.mix = cfg, mix
    st.model = build_program(cfg, seed, device)
    st.engine = InferenceEngine(
        st.model, text_encoder_type=cfg["text_encoder_type"], text_bucket=cfg["text_bucket"],
        time_buckets=mix["time_buckets"], size_buckets=[tuple(mix["frame_size"])],
        device=device)
    st.videos = generator(mix["generator"]).make(mix, seed, device)
    st.sample = st.videos.sample(seed, mix["check_videos"])
    st.results: Dict[int, tuple] = {}
    # warm-up: the longest video of each time bucket the pool uses, twice
    # (the engine keeps up to two clips of a bucket in flight)
    by_bucket = {}
    for i, v in enumerate(st.videos.pool):
        b = min(x for x in mix["time_buckets"] if x >= min(v.frames.shape[0],
                                                         max(mix["time_buckets"])))
        if b not in by_bucket or v.frames.shape[0] > st.videos.pool[by_bucket[b]].frames.shape[0]:
            by_bucket[b] = i
    warm = [st.videos.item(i, -1 - k) for k in range(2) for i in by_bucket.values()]
    for _ in st.engine.infer_videos(iter(warm), depth=mix["depth"]):
        pass
    _sync(device)
    return st


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _trace_wrappers(st, tracer) -> None:
    from neurips2023_soc_torch.models import deformable_transformer, video_swin

    eng, model = st.engine, st.model
    tracer.wrap(eng, "_dispatch_video", "engine.dispatch")
    tracer.wrap(eng, "_collect_video", "engine.collect")
    tracer.wrap(model, "backbone_features", "model.backbone_features",
                lambda pixels, *a, **k: {"frames": pixels.shape[0]})
    tracer.wrap(model, "head", "model.head",
                lambda feats, pad_mask, *a, **k: {"frames": pad_mask.shape[0]})
    tracer.wrap(deformable_transformer, "ms_deform_attn", "k1.call", _msda_record)
    tracer.wrap(video_swin, "window_attention", "k3.call", _wattn_record)


def _msda_record(value, spatial_shapes, loc, attn):
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    return dict(B=B, S=S, M=M, D=D, Lq=Lq, L=L, P=P, value_bytes=value.element_size(),
                attn_bytes=attn.element_size())


def _wattn_record(q, k, v, bias, ids=None):
    B_, H, N, Dh = q.shape
    return dict(B_=B_, H=H, N=N, Dh=Dh, elem_bytes=q.element_size(),
                masked_windows=0 if ids is None else ids.shape[0])


def window(st: State, seconds: float, tracer=None) -> Dict:
    """The measured window: e2e numbers, attempted / failed, and what the
    traced run's readers need. A traced window holds a fixed amount of work
    instead of a time: `trace_passes` passes through the pool, in the seed's
    order, and ends when the last video's masks are on the host."""
    started: List[dict] = []
    done: List[dict] = []
    deadline = None
    videos = None
    if tracer is not None:
        _trace_wrappers(st, tracer)
        videos = st.cell["trace_passes"] * len(st.videos.pool)

    def items():
        nonlocal deadline
        deadline = time.perf_counter() + seconds if videos is None else float("inf")
        while time.perf_counter() < deadline and (videos is None or len(started) < videos):
            index, use, item = st.videos.next()
            started.append(dict(index=index, use=use, frames=item["frames"].shape[0],
                                n_expr=len(item["texts"]), t0=time.perf_counter()))
            yield item

    def loop():
        for res in st.engine.infer_videos(items(), depth=st.mix["depth"]):
            rec = started[len(done)]
            rec["t1"] = time.perf_counter()
            done.append(rec)
            if rec["index"] in st.sample and rec["index"] not in st.results:
                st.results[rec["index"]] = (rec["use"], res)

    if tracer is not None:
        with tracer.profile(cuda=torch.device(st.device).type == "cuda"):
            loop()
        tracer.unwrap()
    else:
        loop()
    if videos is not None:
        seconds = done[-1]["t1"] - started[0]["t0"]
    in_window = [r for r in done if r["t1"] <= deadline]
    masks = sum(r["frames"] * r["n_expr"] for r in in_window)
    lat = sorted((r["t1"] - r["t0"]) * 1e3 for r in in_window)
    out = {"attempted": len(started), "failed": len(started) - len(done),
           "seconds": seconds, "videos": len(in_window), "in_window": in_window,
           "e2e": {"masks_per_s": masks / seconds}}
    if len(lat) >= 2:
        out["e2e"]["video_p90_ms"] = statistics.quantiles(lat, n=10, method="inclusive")[8]
        out["e2e"]["video_p50_ms"] = statistics.median(lat)
    return out


def model_flops(st: State, done: List[dict]) -> float:
    """FLOPs the inputs of the given videos need: the backbone over each
    video's real frames and the head once per expression."""
    from ..work.model import ModelWork

    work = ModelWork(st.cfg)
    h, w = st.mix["frame_size"]
    chunk = max(st.mix["time_buckets"])
    total = 0.0
    for r in done:
        t = r["frames"]
        while t > 0:
            bb, head = work.inference(min(t, chunk), h, w)
            total += bb + r["n_expr"] * head
            t -= chunk
    return total


def release(st: State) -> None:
    """Frees the program before the reference runs."""
    for name in ("engine", "model"):
        if hasattr(st, name):
            delattr(st, name)
    gc.collect()
    if torch.device(st.device).type == "cuda":
        torch.cuda.empty_cache()


def reference_results(st: State, model, indices) -> Dict[int, list]:
    out = {}
    for i in indices:
        use, _ = st.results[i]
        item = st.videos.item(i, use)
        out[i] = reference_video(
            model, item["frames"], item["texts"], item["original_size"],
            st.mix["time_buckets"], [tuple(st.mix["frame_size"])],
            st.cfg["text_encoder_type"], st.cfg["text_bucket"])
    return out


def fill_sample(st: State) -> None:
    """Runs the sampled videos the window did not reach (a short window)."""
    for i in st.sample:
        if i not in st.results:
            use = 10 ** 6 + i
            st.results[i] = (use, st.engine.infer_video_multi(**st.videos.item(i, use)))


def reference_sides(st: State, weights) -> tuple:
    """The outputs of the checked videos of the reference in float32 and in
    bfloat16."""
    plain_float32()
    ref = build_reference(st.cfg, torch.float32, st.device)
    ref.load_state_dict(weights, strict=True)
    refs = reference_results(st, ref.eval(), st.sample)
    del ref
    low = build_reference(st.cfg, torch.bfloat16, st.device)
    low.load_state_dict(weights, strict=True)
    lows = reference_results(st, low.eval(), st.sample)
    del low
    return refs, lows


def lengths(st: State) -> Dict[int, int]:
    return {i: st.videos.pool[i].frames.shape[0] for i in st.sample}


def check(st: State) -> Dict[str, float]:
    fill_sample(st)
    release(st)
    refs, bf16 = reference_sides(st, make_weights(st.cfg, st.seed, st.device))
    got = {i: st.results[i][1] for i in st.sample}
    return correct.engine_numbers(got, refs, bf16, lengths(st))


def control_masks(ref_out: list, t: int) -> list:
    """The masks a model gives from its own reference outputs: the query of
    the best whole-video score, thresholded at logit 0."""
    return [(r["logits"](int(np.argmax(r["scores"]))) > 0).to(torch.uint8).cpu().numpy()
            for r in ref_out]
