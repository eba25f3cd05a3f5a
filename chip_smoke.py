#!/usr/bin/env python3
"""Smoke run of the PyTorch port (neurips2023_soc_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero and
prints no result):
  1. device  — require CUDA; print the card's name and power limit.
  2. build   — build every CUDA kernel of the main path from csrc/ with nvcc.
  3. kernels — hold each kernel against its plain PyTorch version on the card
               at the main path's shapes (f32: rtol = atol = 1e-5; bf16 against
               the plain version in f32 on the same bf16-rounded inputs:
               rtol = atol = 1.6e-2, two bf16 ulps of the once-rounded output)
               and time kernel, plain version and a grid_sample composition.
  4. e2e     — the main path: Video-Swin-B SOC (d_model 256, 20 queries, FFN
               2048, 3+3 deformable layers, VOC 3+3, roberta-base, bf16) from a
               seeded random init, InferenceEngine.infer_videos over 3 videos
               of 16 x 360 x 640 uint8 frames with one expression each. Every
               kernel counter is set to 0 just before and read just after.
  5. small   — a small SOC in float32 on the card against the same model on
               the CPU (plain versions), as the reference on a small input.
The second-to-last lines are the card's name/power limit and a JSON object of
the kernels; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from neurips2023_soc_torch.config import load_config
from neurips2023_soc_torch.inference import InferenceEngine
from neurips2023_soc_torch.models import build_model
from neurips2023_soc_torch.models.common import init_weights
from neurips2023_soc_torch.models.deformable_transformer import _offset_grid_bias
from neurips2023_soc_torch.models.soc import SOC
from neurips2023_soc_torch.ops import _build
from neurips2023_soc_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_torch

ROOT = Path(__file__).resolve().parent
# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, f32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# the main path's pyramid at 360 x 640 (strides 8, 16, 32, 64)
LEVELS = ((45, 80), (23, 40), (12, 20), (6, 10))
B_CLIP, M, D, P = 16, 8, 32, 4
NUM_VIDEOS, T_CLIP, HEIGHT, WIDTH = 3, 16, 360, 640
MSDA_PER_CLIP = 6  # 3 encoder + 3 decoder layers


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of `iters` CUDA-event timings after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------- kernels
def msda_inputs(Lq: int, levels, dtype, uniform: bool, seed: int, B: int = B_CLIP):
    """MSDA inputs on the card. Realistic locations sit around each query's
    reference point on the direction grid the sampling-offset init produces
    (plus noise); `uniform` draws them from [-0.2, 1.2] instead."""
    g = torch.Generator().manual_seed(seed)
    L = len(levels)
    S = sum(h * w for h, w in levels)
    value = torch.randn(B, S, M, D, generator=g)
    if uniform:
        loc = torch.rand(B, Lq, M, L, P, 2, generator=g) * 1.4 - 0.2
    else:
        if Lq == S:  # encoder: every token's own centre
            ref = torch.cat([torch.stack(torch.meshgrid(
                (torch.arange(w) + 0.5) / w, (torch.arange(h) + 0.5) / h,
                indexing="xy"), -1).reshape(-1, 2) for h, w in levels])
        else:  # decoder: object queries anywhere in the frame
            ref = torch.rand(Lq, 2, generator=g)
        grid = torch.from_numpy(_offset_grid_bias(M, L, P)).view(M, L, P, 2)
        off = grid + 0.5 * torch.randn(B, Lq, M, L, P, 2, generator=g)
        wh = torch.tensor([[w, h] for h, w in levels], dtype=torch.float32)
        loc = ref[None, :, None, None, None, :] + off / wh[:, None, :]
    attn = torch.softmax(torch.randn(B, Lq, M, L * P, generator=g), -1).view(
        B, Lq, M, L, P)
    dev = torch.device("cuda")
    return (value.to(dev, dtype), loc.to(dev).contiguous(), attn.to(dev, dtype))


def msda_grid_sample(value, levels, loc, attn):
    """The same function as one grid_sample per level (the yardstick)."""
    B, S, Mh, Dh = value.shape
    Lq, L, Pn = loc.shape[1], loc.shape[3], loc.shape[4]
    v = value.permute(0, 2, 3, 1)
    out, start = 0, 0
    for l, (h, w) in enumerate(levels):
        v_l = v[..., start:start + h * w].reshape(B * Mh, Dh, h, w)
        start += h * w
        grid = (2 * loc[:, :, :, l] - 1).permute(0, 2, 1, 3, 4).reshape(B * Mh, Lq, Pn, 2)
        s = F.grid_sample(v_l, grid.to(value.dtype), mode="bilinear",
                          padding_mode="zeros", align_corners=False)
        wl = attn[:, :, :, l].permute(0, 2, 1, 3).reshape(B * Mh, 1, Lq, Pn)
        out = out + (s * wl.to(value.dtype)).sum(-1)
    return out.view(B, Mh, Dh, Lq).permute(0, 3, 1, 2).reshape(B, Lq, Mh * Dh)


def msda_bound_ms(value, levels, loc, attn):
    """Least time for the card: every input read once and the output written
    once over HBM bandwidth, against 2 flops per channel per in-range corner
    (what these locations need) over the f32 rate."""
    B, S, Mh, Dh = value.shape
    out_bytes = B * loc.shape[1] * Mh * Dh * value.element_size()
    nbytes = (value.numel() * value.element_size() + loc.numel() * 4
              + attn.numel() * attn.element_size() + out_bytes)
    corners = 0
    for l, (h, w) in enumerate(levels):
        x0 = torch.floor(loc[:, :, :, l, :, 0] * w - 0.5)
        y0 = torch.floor(loc[:, :, :, l, :, 1] * h - 0.5)
        for dx in (0, 1):
            for dy in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                corners += int(((xi >= 0) & (xi <= w - 1) & (yi >= 0)
                                & (yi <= h - 1)).sum())
    flops = 2.0 * Dh * corners
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_msda() -> dict:
    S = sum(h * w for h, w in LEVELS)
    cases = [  # name, Lq, levels, dtype, uniform
        ("encoder f32", S, LEVELS, torch.float32, False),
        ("decoder f32", 20, LEVELS, torch.float32, False),
        ("encoder bf16", S, LEVELS, torch.bfloat16, False),
        ("decoder bf16", 20, LEVELS, torch.bfloat16, False),
        ("uniform + size-1 level f32", 300, ((9, 17), (5, 9), (3, 5), (1, 1)),
         torch.float32, True),
    ]
    report = {}
    for i, (name, Lq, levels, dtype, uniform) in enumerate(cases):
        value, loc, attn = msda_inputs(Lq, levels, dtype, uniform, seed=i)
        got = ms_deform_attn(value, levels, loc, attn)
        torch.cuda.synchronize()
        want = ms_deform_attn_torch(value.float(), levels, loc, attn.float())
        tol = 1e-5 if dtype == torch.float32 else 1.6e-2
        err = (got.float() - want).abs().max().item()
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol,
                                   msg=lambda m: f"MSDA kernel vs plain, {name}: {m}")
        log(f"[kernels] ms_deform_attn {name}: max_abs_err {err:.3e} (tol {tol})")
        report[name] = {"err": err, "inputs": (value, loc, attn, levels)}
    # times at the main path's dominant call: the encoder, bf16
    value, loc, attn, levels = report["encoder bf16"]["inputs"]
    t = {
        "ms": time_ms(lambda: ms_deform_attn(value, levels, loc, attn)),
        "plain_ms": time_ms(lambda: ms_deform_attn_torch(value, levels, loc, attn), iters=20),
        "library_ms": time_ms(lambda: msda_grid_sample(value, levels, loc, attn)),
    }
    dvalue, dloc, dattn, _ = report["decoder bf16"]["inputs"]
    dec_ms = time_ms(lambda: ms_deform_attn(dvalue, LEVELS, dloc, dattn))
    bound, bound_by = msda_bound_ms(value, levels, loc, attn)
    dec_bound, _ = msda_bound_ms(dvalue, LEVELS, dloc, dattn)
    log(f"[kernels] ms_deform_attn encoder bf16 {tuple(value.shape)} Lq={loc.shape[1]}: "
        f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, grid_sample "
        f"{t['library_ms']:.4f} ms, bound {bound:.4f} ms ({bound_by})")
    log(f"[kernels] ms_deform_attn decoder bf16 Lq=20: kernel {dec_ms:.4f} ms, "
        f"bound {dec_bound:.4f} ms")
    return dict(name="ms_deform_attn_fwd", route="cuda",
                source="neurips2023_soc_torch/csrc/ms_deform_attn_fwd.cu",
                replaces="neurips2023_soc_tpu/ops/pallas_msda.py:376",
                max_abs_err=report["encoder bf16"]["err"], bound_ms=bound,
                bound_by=bound_by, **t)


# ---------------------------------------------------------------- e2e
def main_path() -> dict:
    cfg = load_config(ROOT / "configs" / "refer_youtube_vos.yaml",
                      overrides={"backbone": "video-swin-b", "compute_dtype": "bfloat16"})
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[e2e] built SOC video-swin-b bf16 ({n_params / 1e6:.1f} M params) in "
        f"{time.perf_counter() - t0:.1f} s")
    engine = InferenceEngine(model, text_encoder_type=cfg.text_encoder_type,
                             text_bucket=cfg.text_bucket, size_buckets=((HEIGHT, WIDTH),))
    rng = np.random.RandomState(0)
    videos = [rng.randint(0, 256, (T_CLIP, HEIGHT, WIDTH, 3)).astype(np.uint8)
              for _ in range(NUM_VIDEOS)]
    texts = ["a person riding a bike", "the dog on the left", "a red car turning"]

    t0 = time.perf_counter()
    engine.infer_video(videos[0], texts[0])  # warm-up (cuDNN, allocator)
    torch.cuda.synchronize()
    log(f"[e2e] warm-up video in {time.perf_counter() - t0:.1f} s")

    items = [dict(frames=v, texts=[t]) for v, t in zip(videos, texts)]
    ms_deform_attn.launches = 0
    ms_deform_attn.plain_calls = 0
    t0 = time.perf_counter()
    results = list(engine.infer_videos(items))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = ms_deform_attn.launches, ms_deform_attn.plain_calls
    if launches != MSDA_PER_CLIP * NUM_VIDEOS:
        raise RuntimeError(f"MSDA kernel launched {launches} times over {NUM_VIDEOS} "
                           f"clips, expected {MSDA_PER_CLIP} per clip")
    if plain != 0:
        raise RuntimeError(f"the main path called the plain MSDA {plain} times")
    for (masks,) in results:
        if masks.shape != (T_CLIP, HEIGHT, WIDTH) or masks.dtype != np.uint8:
            raise RuntimeError(f"masks {masks.shape} {masks.dtype}")
        if not set(np.unique(masks).tolist()) <= {0, 1}:
            raise RuntimeError("masks hold values other than 0 and 1")
    engine_fps = NUM_VIDEOS * T_CLIP / wall
    log(f"[e2e] infer_videos: {NUM_VIDEOS} videos x {T_CLIP} frames in {wall:.3f} s "
        f"= {engine_fps:.2f} frames/s; MSDA launches {launches}, plain calls {plain}; "
        f"mask foreground share {np.mean([m.mean() for (m,) in results]):.4f}")

    # the logits of one clip forward, and the device time of the forward
    pad = torch.zeros(T_CLIP, 1, HEIGHT, WIDTH, dtype=torch.bool, device="cuda")
    px = torch.from_numpy(videos[0]).cuda()[:, None].float() / 255.0
    ids, msk = (torch.from_numpy(a).cuda() for a in engine.tokenizer([texts[0]]))
    with torch.no_grad():
        out = model(px, pad, ids, msk)
        for k in ("pred_masks", "pred_cls", "pred_boxes", "pred_logit",
                  "text_sentence_feature"):
            if not torch.isfinite(out[k].float()).all():
                raise RuntimeError(f"non-finite {k}")
        clip_ms = time_ms(lambda: model(px, pad, ids, msk), iters=5, warmup=1)
        feats = model.backbone_features(px, pad)
        backbone_ms = time_ms(lambda: model.backbone_features(px, pad), iters=5, warmup=1)
        head_ms = time_ms(lambda: model.head(feats, pad, ids, msk), iters=5, warmup=1)
    device_fps = T_CLIP * 1e3 / clip_ms
    log(f"[e2e] logits finite; clip forward {clip_ms:.2f} ms on the device = "
        f"{1e3 / clip_ms:.3f} clips/s = {device_fps:.2f} frames/s (backbone "
        f"{backbone_ms:.2f} ms, head {head_ms:.2f} ms); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dict(launches=launches, engine_fps=engine_fps, device_fps=device_fps)


def small_reference() -> None:
    """A small float32 SOC on the card against the same weights on the CPU."""
    kw = dict(backbone_name="video-swin-t", d_model=64, num_queries=5,
              dim_feedforward=128, enc_layers=1, dec_layers=2, voc_enc_layers=1,
              voc_dec_layers=1, text_encoder_type="roberta-tiny")
    cpu = init_weights(SOC(**kw), torch.Generator().manual_seed(1)).eval()
    gpu = init_weights(SOC(**kw), torch.Generator().manual_seed(1)).cuda().eval()
    rng = np.random.RandomState(1)
    px = torch.from_numpy(rng.randn(4, 2, 48, 64, 3).astype(np.float32))
    pad = torch.zeros(4, 2, 48, 64, dtype=torch.bool)
    pad[:, 1, 40:] = True
    ids = torch.from_numpy(rng.randint(3, 1000, (2, 8)).astype(np.int32))
    msk = torch.ones(2, 8, dtype=torch.int32)
    with torch.no_grad():
        want = cpu(px, pad, ids, msk)
        got = gpu(px.cuda(), pad.cuda(), ids.cuda(), msk.cuda())
    for k in ("pred_masks", "pred_cls", "pred_boxes", "pred_logit"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-3, atol=1e-3,
                                   msg=lambda m: f"small SOC cuda vs cpu, {k}: {m}")
    log("[small] SOC video-swin-t d_model 64 f32: card == CPU within 1e-3")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[build] {', '.join(p.name for p in built.values())} in "
        f"{time.perf_counter() - t0:.1f} s")

    kernel = check_msda()
    e2e = main_path()
    kernel["launches"] = e2e["launches"]
    log(f"[e2e] {smi}: device {e2e['device_fps']:.2f} frames/s, engine "
        f"{e2e['engine_fps']:.2f} frames/s (Video-Swin-B bf16, 16 x {HEIGHT} x {WIDTH})")
    small_reference()

    log(smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kernel[k] for k in keys}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
