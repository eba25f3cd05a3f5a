#!/usr/bin/env python3
"""Smoke run of the PyTorch port (neurips2023_soc_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero and
prints no result):
  1. device  — require CUDA; print the card's name and power limit.
  2. build   — build every CUDA kernel from csrc/ with nvcc, one process per
               source, all started together.
  3. kernels — hold each kernel against its plain PyTorch version on the card
               at the main paths' shapes and time kernel, plain version and
               the library yardstick.
               K1 (MSDA forward) and K2 (MSDA backward) on the cases of
               MSDA_CASES: the path's encoder and decoder (B = 16 for K1, the
               clip; B = 8 for K2, the training shape), a small pyramid with a
               size-1 level and uniform locations, D = 8 (the tiny config's
               heads), P = 3 (the run-time point loop) and D = 24, each on the
               route its shape takes (fwd_route / bwd_route: vec, or scalar at
               D = 24), every route in f32 and in bf16.
               K1: f32 rtol = atol = 1e-5; bf16 against the plain version in
               f32 on the same bf16-rounded inputs, rtol = atol = 1.6e-2 (two
               bf16 ulps of the once-rounded output).
               K2: f32 rtol = 1e-4 and atol = 1e-4 of each output's scale
               (max(1, max|output|)): the JAX suite's backward tolerance, with
               the absolute part scaled because d_loc = attn * W * sum(...)
               reaches 1e3 at W = 80 and a near-zero entry is a cancellation
               of such terms summed in another order; d_value is summed with
               atomics, so its order, and its last bits, vary from run to run.
               bf16 against the plain backward in f32 on the same bf16-rounded
               inputs and cotangent: the bf16 outputs (d_value, d_attn) within
               atol = two bf16 ulps of their scale (2 * 2**-7 * max|output|);
               d_loc, f32 in every case, at the f32 tolerance above.
               Control: the bf16 encoder case again with the last point of
               every level zeroed in attn on the kernel side must fail (K1's
               output; K2's d_value and d_loc). K1 and K2 are timed as 20
               back-to-back launches per event pair.
               K3 (Swin window attention) at the four Video-Swin-B stage
               shapes of a 16 x 360 x 640 clip, masked and unmasked (stage 3
               also with q, k, v as the strided views of one fused qkv
               buffer, as the backbone passes them), a clamped window, a
               2D-Swin window, N = 512, N = 1 and a prime number of windows,
               with a bias of a trained table's spread (std 1.5):
               f32 rtol = atol = 2e-5; bf16 against the plain version in f32
               on the same bf16-rounded inputs, rtol 0 and atol two bf16 ulps
               of the largest expected magnitude; each case with N > 1 must
               fail its tolerance when the kernel is given a zeroed bias. K3
               and SDPA are timed at the eight stage shapes and summed over
               one clip's 24 blocks.
  4. e2e     — the inference path: Video-Swin-B SOC (d_model 256, 20 queries,
               FFN 2048, 3+3 deformable layers, VOC 3+3, roberta-base, bf16)
               from a seeded random init, InferenceEngine.infer_videos over 3
               videos of 16 x 360 x 640 uint8 frames with one expression each.
     e2e-k3  — the same workload and weights with swin_attn_impl: pallas,
               through EnginePool (one engine on the card) and
               run_videos_pipelined: exactly 24 K3 and 6 K1 launches per clip,
               no plain window attention or MSDA call; the share of mask
               pixels on which it differs from phase e2e is reported; one
               video with pixel_format yuv420 and one with uint8
               probabilities; one torch.profiler pass over the backbone
               (device time by kernel); then each of one clip's 24 K3 calls
               (two bf16 ulps of scale) and 6 K1 calls (K1's bf16 tolerance)
               held against the plain version in f32 on the same inputs.
  5. train   — the training path at the same width: Trainer over
               SyntheticRVOSDataset clips of 8 x 360 x 640, batch 1, one epoch
               of 4 steps (the first a warm-up), dropout 0.1, drop path 0.2,
               frozen roberta-base; checkpoint written and read back; then
               one more step whose 6 K2 calls are each held against the
               plain backward in f32 on the same inputs (K2's tolerances).
  6. small   — a small SOC in float32 on the card against the same model on
               the CPU (plain versions), as the reference on a small input,
               with swin_attn_impl xla and pallas.
Every kernel counter is set to 0 just before each path is driven and read
just after. `python3 chip_smoke.py --msda-times` only times K1 and K2 at the
path's shapes (a copy of this script in an older checkout times that
checkout's kernels: an A/B in one chip call). The second-to-last lines are the card's name/power limit and a
JSON object of the kernels; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import importlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from neurips2023_soc_torch.config import load_config
from neurips2023_soc_torch.data import SyntheticRVOSDataset, iterate_batches
from neurips2023_soc_torch.inference import EnginePool, InferenceEngine, run_videos_pipelined
from neurips2023_soc_torch.losses import compute_criterion, total_loss
from neurips2023_soc_torch.models import build_model
from neurips2023_soc_torch.models.common import init_weights
from neurips2023_soc_torch.models.deformable_transformer import _offset_grid_bias
from neurips2023_soc_torch.models.soc import SOC
from neurips2023_soc_torch.models.text_encoder import build_tokenizer
from neurips2023_soc_torch.ops import _build
from neurips2023_soc_torch.ops.ms_deform_attn import (ms_deform_attn, ms_deform_attn_torch,
                                                      ms_deform_attn_torch_bwd)
from neurips2023_soc_torch.ops.window_attention import (_kernel_layout, mask_from_ids,
                                                        window_attention,
                                                        window_attention_ref,
                                                        window_attention_torch)
from neurips2023_soc_torch.models import video_swin
from neurips2023_soc_torch.models.video_swin import _np_window_region_ids
from neurips2023_soc_torch.training import Trainer
from neurips2023_soc_torch.training.train_step import TARGET_KEYS, device_batch

ROOT = Path(__file__).resolve().parent
# the wrapper module (the package exports the function of the same name)
msda_mod = importlib.import_module("neurips2023_soc_torch.ops.ms_deform_attn")
# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, f32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12  # dense bf16 tensor-core peak
# the main path's pyramid at 360 x 640 (strides 8, 16, 32, 64)
LEVELS = ((45, 80), (23, 40), (12, 20), (6, 10))
B_CLIP, M, D, P = 16, 8, 32, 4
NUM_VIDEOS, T_CLIP, HEIGHT, WIDTH = 3, 16, 360, 640
MSDA_PER_CLIP = 6  # 3 encoder + 3 decoder layers
K3_PER_CLIP = 24  # one per Video-Swin-B block (2 + 2 + 18 + 2), 12 of them shifted
T_TRAIN, TRAIN_STEPS = 8, 4  # training clip length (window_size), steps


def reset_counters() -> None:
    for name in ("launches", "plain_calls", "bwd_launches", "plain_bwd_calls"):
        setattr(ms_deform_attn, name, 0)
    window_attention.launches = window_attention.plain_calls = 0
    window_attention_torch.calls = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3, reps: int = 1) -> float:
    """Median of `iters` CUDA-event timings, each of `reps` back-to-back
    calls and divided by `reps`, after `warmup` calls. With reps > 1 the
    host's launch overhead hides behind the device's work, so a call shorter
    than that overhead still reads its device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


# ---------------------------------------------------------------- kernels
def msda_inputs(Lq: int, levels, dtype, uniform: bool, seed: int, B: int = B_CLIP,
                dim: int = D, points: int = P):
    """MSDA inputs on the card (M heads of width `dim`, `points` per level).
    Realistic locations sit around each query's reference point on the
    direction grid the sampling-offset init produces (plus noise); `uniform`
    draws them from [-0.2, 1.2] instead."""
    g = torch.Generator().manual_seed(seed)
    L = len(levels)
    S = sum(h * w for h, w in levels)
    value = torch.randn(B, S, M, dim, generator=g)
    if uniform:
        loc = torch.rand(B, Lq, M, L, points, 2, generator=g) * 1.4 - 0.2
    else:
        if Lq == S:  # encoder: every token's own centre
            ref = torch.cat([torch.stack(torch.meshgrid(
                (torch.arange(w) + 0.5) / w, (torch.arange(h) + 0.5) / h,
                indexing="xy"), -1).reshape(-1, 2) for h, w in levels])
        else:  # decoder: object queries anywhere in the frame
            ref = torch.rand(Lq, 2, generator=g)
        grid = torch.from_numpy(_offset_grid_bias(M, L, points)).view(M, L, points, 2)
        off = grid + 0.5 * torch.randn(B, Lq, M, L, points, 2, generator=g)
        wh = torch.tensor([[w, h] for h, w in levels], dtype=torch.float32)
        loc = ref[None, :, None, None, None, :] + off / wh[:, None, :]
    attn = torch.softmax(torch.randn(B, Lq, M, L * points, generator=g), -1).view(
        B, Lq, M, L, points)
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


def in_range_corners(levels, loc) -> int:
    """Bilinear corners inside their level over all samples (what these
    locations need)."""
    corners = 0
    for l, (h, w) in enumerate(levels):
        x0 = torch.floor(loc[:, :, :, l, :, 0] * w - 0.5)
        y0 = torch.floor(loc[:, :, :, l, :, 1] * h - 0.5)
        for dx in (0, 1):
            for dy in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                corners += int(((xi >= 0) & (xi <= w - 1) & (yi >= 0)
                                & (yi <= h - 1)).sum())
    return corners


def msda_bound_ms(value, levels, loc, attn):
    """Least time for the card: every input read once and the output written
    once over HBM bandwidth, against 2 flops per channel per in-range corner
    (what these locations need) over the f32 rate."""
    B, S, Mh, Dh = value.shape
    out_bytes = B * loc.shape[1] * Mh * Dh * value.element_size()
    nbytes = (value.numel() * value.element_size() + loc.numel() * 4
              + attn.numel() * attn.element_size() + out_bytes)
    corners = in_range_corners(levels, loc)
    flops = 2.0 * Dh * corners
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# MSDA kernel cases: name, route the shape must take, Lq, levels, dtype, uniform
# locations, head width, points per level. Every route runs in f32 and in bf16.
SMALL_LEVELS = ((9, 17), (5, 9), (3, 5), (1, 1))
MSDA_CASES = [
    ("encoder f32", "vec", sum(h * w for h, w in LEVELS), LEVELS, torch.float32, False, D, P),
    ("decoder f32", "vec", 20, LEVELS, torch.float32, False, D, P),
    ("encoder bf16", "vec", sum(h * w for h, w in LEVELS), LEVELS, torch.bfloat16, False, D, P),
    ("decoder bf16", "vec", 20, LEVELS, torch.bfloat16, False, D, P),
    ("uniform + size-1 level f32", "vec", 300, SMALL_LEVELS, torch.float32, True, D, P),
    ("D=8 (tiny config heads) bf16", "vec", 300, SMALL_LEVELS, torch.bfloat16, True, 8, P),
    ("P=3 (run-time point loop) f32", "vec", 300, SMALL_LEVELS, torch.float32, True, D, 3),
    ("D=24 f32", "scalar", 300, SMALL_LEVELS, torch.float32, True, 24, P),
    ("D=24 bf16", "scalar", 300, SMALL_LEVELS, torch.bfloat16, True, 24, P),
]


def miss_ratio(got, want, rtol, atol) -> float:
    """max |got - want| / (atol + rtol |want|): above 1 fails the tolerance."""
    return ((got.float() - want).abs() / (atol + rtol * want.abs())).max().item()


def fwd_tol(dtype) -> float:
    return 1e-5 if dtype == torch.float32 else 1.6e-2


def check_msda() -> dict:
    """K1 against the plain version on every case of MSDA_CASES (B = 16 at the
    path's pyramid, B = 2 elsewhere), each on the route its shape takes. A
    control reruns the bf16 encoder case with the last point of every level
    zeroed in attn on the kernel side and raises unless that fails the
    tolerance. Times the kernel as 20 back-to-back calls per event pair."""
    report = {}
    for i, (name, route, Lq, levels, dtype, uniform, dim, pts) in enumerate(MSDA_CASES):
        if msda_mod.fwd_route(dim, pts) != route:
            raise RuntimeError(f"K1 {name}: the shape takes route "
                               f"{msda_mod.fwd_route(dim, pts)}, expected {route}")
        B = B_CLIP if levels == LEVELS else 2
        value, loc, attn = msda_inputs(Lq, levels, dtype, uniform, seed=i, B=B, dim=dim,
                                       points=pts)
        got = ms_deform_attn(value, levels, loc, attn)
        torch.cuda.synchronize()
        want = ms_deform_attn_torch(value.float(), levels, loc, attn.float())
        tol = fwd_tol(dtype)
        err = (got.float() - want).abs().max().item()
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol,
                                   msg=lambda m: f"MSDA kernel vs plain, {name}: {m}")
        control = ""
        if name == "encoder bf16":  # one dropped sample per level must show
            dropped = attn.clone()
            dropped[..., -1] = 0
            miss = miss_ratio(ms_deform_attn(value, levels, loc, dropped), want, tol, tol)
            if miss <= 1.0:
                raise RuntimeError(f"K1 {name}: the tolerance cannot see the last point of "
                                   f"each level dropped (error {miss:.3f} of the tolerance)")
            control = f"; last point of each level dropped: {miss:.1f}x the tolerance"
        log(f"[kernels] ms_deform_attn {name} ({route} route, B={B}, D={dim}, P={pts}): "
            f"max_abs_err {err:.3e} (tol {tol}){control}")
        report[name] = {"err": err, "inputs": (value, loc, attn, levels)}
    # times at the main path's dominant call: the encoder, bf16
    value, loc, attn, levels = report["encoder bf16"]["inputs"]
    t = {
        "ms": time_ms(lambda: ms_deform_attn(value, levels, loc, attn), reps=20),
        "plain_ms": time_ms(lambda: ms_deform_attn_torch(value, levels, loc, attn), iters=20),
        "library_ms": time_ms(lambda: msda_grid_sample(value, levels, loc, attn)),
    }
    dvalue, dloc, dattn, _ = report["decoder bf16"]["inputs"]
    dec_ms = time_ms(lambda: ms_deform_attn(dvalue, LEVELS, dloc, dattn), reps=20)
    bound, bound_by = msda_bound_ms(value, levels, loc, attn)
    dec_bound, _ = msda_bound_ms(dvalue, LEVELS, dloc, dattn)
    log(f"[kernels] ms_deform_attn encoder bf16 {tuple(value.shape)} Lq={loc.shape[1]}: "
        f"kernel {t['ms']:.4f} ms (20 calls per timing), plain {t['plain_ms']:.4f} ms, "
        f"grid_sample {t['library_ms']:.4f} ms, bound {bound:.4f} ms ({bound_by})")
    log(f"[kernels] ms_deform_attn decoder bf16 Lq=20: kernel {dec_ms:.4f} ms, "
        f"bound {dec_bound:.4f} ms")
    return dict(name="ms_deform_attn_fwd", route="cuda",
                note="vec route: 8-channel slices, geometry once per sample; f32 CUDA cores",
                source="neurips2023_soc_torch/csrc/ms_deform_attn_fwd.cu",
                replaces="neurips2023_soc_tpu/ops/pallas_msda.py:376",
                max_abs_err=report["encoder bf16"]["err"], bound_ms=bound,
                bound_by=bound_by, **t)


def time_bwd_ms(fn, value, levels, loc, attn, grad, iters: int = 10,
                warmup: int = 2) -> float:
    """Median CUDA-event time of torch.autograd.grad through `fn` alone: the
    forward that builds the graph runs outside the timed region."""
    times = []
    for i in range(warmup + iters):
        inputs = [t.detach().requires_grad_() for t in (value, loc, attn)]
        out = fn(inputs[0], levels, inputs[1], inputs[2])
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.grad(out, inputs, grad)
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def msda_bwd_bound_ms(value, levels, loc, attn):
    """Least time for the card: value, loc, attn and the cotangent read once,
    d_value (value dtype), d_loc (f32) and d_attn (attn dtype) written once,
    over HBM bandwidth; against 4 flops per channel per in-range corner (the
    dot with the cotangent and the scaled scatter) over the f32 rate."""
    B, S, Mh, Dh = value.shape
    g_bytes = B * loc.shape[1] * Mh * Dh * value.element_size()
    nbytes = 2 * (value.numel() * value.element_size() + loc.numel() * 4
                  + attn.numel() * attn.element_size()) + g_bytes
    corners = in_range_corners(levels, loc)
    flops = 4.0 * Dh * corners
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bwd_tols(x, w):
    """K2's tolerance for one output: f32 outputs (d_loc in every case) rtol 1e-4
    and atol 1e-4 of the output's scale; bf16 outputs two bf16 ulps of scale."""
    if x.dtype == torch.float32:
        return 1e-4, 1e-4 * max(1.0, w.abs().max().item())
    return 0.0, 2 * 2.0 ** -7 * w.abs().max().item()


def check_msda_bwd() -> dict:
    """K2 against the plain backward on every case of MSDA_CASES (B = 8, the
    training shape, at the path's pyramid; B = 2 elsewhere), through autograd,
    each on the route its shape takes; the bf16 encoder case's control drops the
    last point of each level from attn on the kernel side and must fail. Times
    the kernel as 20 back-to-back launches per event pair."""
    report = {}
    for i, (name, route, Lq, levels, dtype, uniform, dim, pts) in enumerate(MSDA_CASES):
        if msda_mod.bwd_route(dim, pts) != route:
            raise RuntimeError(f"K2 {name}: the shape takes route "
                               f"{msda_mod.bwd_route(dim, pts)}, expected {route}")
        B = T_TRAIN if levels == LEVELS else 2
        value, loc, attn = msda_inputs(Lq, levels, dtype, uniform, seed=10 + i, B=B, dim=dim,
                                       points=pts)
        g = torch.randn(B, Lq, M * dim, generator=torch.Generator().manual_seed(i))
        g = g.to("cuda", dtype)
        inputs = [t.detach().requires_grad_() for t in (value, loc, attn)]
        out = ms_deform_attn(inputs[0], levels, inputs[1], inputs[2])
        got = torch.autograd.grad(out, inputs, g)
        torch.cuda.synchronize()
        want = ms_deform_attn_torch_bwd(value.float(), levels, loc, attn.float(), g.float())
        errs = []
        for oname, x, w in zip(("d_value", "d_loc", "d_attn"), got, want):
            rtol, atol = bwd_tols(x, w)
            err = (x.float() - w).abs().max().item()
            torch.testing.assert_close(
                x.float(), w, rtol=rtol, atol=atol,
                msg=lambda m: f"MSDA backward kernel vs plain, {name}, {oname}: {m}")
            errs.append(err)
            log(f"[kernels] ms_deform_attn_bwd {name} ({route} route, B={B}, D={dim}, "
                f"P={pts}) {oname} {x.dtype}: max_abs_err {err:.3e} (rtol {rtol}, "
                f"atol {atol:.3e})")
        if name == "encoder bf16":  # one dropped sample per level must show
            dropped = attn.clone()
            dropped[..., -1] = 0
            wrong = msda_mod._launch_bwd(value, levels, loc, dropped, g)
            misses = [miss_ratio(x, w, *bwd_tols(x, w)) for x, w in zip(wrong, want)]
            if max(misses[:2]) <= 1.0:
                raise RuntimeError(f"K2 {name}: the tolerance cannot see the last point of "
                                   f"each level dropped (d_value, d_loc errors {misses[:2]} "
                                   f"of the tolerance)")
            log(f"[kernels] ms_deform_attn_bwd {name}: last point of each level dropped: "
                f"d_value {misses[0]:.1f}x, d_loc {misses[1]:.1f}x the tolerance (d_attn does "
                f"not depend on attn)")
        report[name] = {"err": max(errs), "inputs": (value, loc, attn, levels, g)}
    value, loc, attn, levels, g = report["encoder bf16"]["inputs"]
    t = {
        "ms": time_ms(lambda: msda_mod._launch_bwd(value, levels, loc, attn, g), reps=20),
        "plain_ms": time_ms(lambda: ms_deform_attn_torch_bwd(value, levels, loc, attn, g),
                            iters=10),
        "library_ms": time_bwd_ms(msda_grid_sample, value, levels, loc, attn, g),
    }
    autograd_ms = time_bwd_ms(ms_deform_attn, value, levels, loc, attn, g)
    dvalue, dloc, dattn, _, dg = report["decoder bf16"]["inputs"]
    dec_ms = time_ms(lambda: msda_mod._launch_bwd(dvalue, LEVELS, dloc, dattn, dg), reps=20)
    bound, bound_by = msda_bwd_bound_ms(value, levels, loc, attn)
    dec_bound = msda_bwd_bound_ms(dvalue, LEVELS, dloc, dattn)[0]
    log(f"[kernels] ms_deform_attn_bwd encoder bf16 {tuple(value.shape)} Lq={loc.shape[1]}: "
        f"kernel {t['ms']:.4f} ms (20 launches per timing; {autograd_ms:.4f} ms as one "
        f"autograd.grad per timing), plain {t['plain_ms']:.4f} ms, grid_sample backward "
        f"{t['library_ms']:.4f} ms, bound {bound:.4f} ms ({bound_by})")
    log(f"[kernels] ms_deform_attn_bwd decoder bf16 Lq=20: kernel {dec_ms:.4f} ms, "
        f"bound {dec_bound:.4f} ms")
    return dict(name="ms_deform_attn_bwd", route="cuda",
                note="vec route: 8-channel slices, a block's hits on one corner merged in a "
                     "shared-memory hash table, 16-byte vector reductions of d_value",
                source="neurips2023_soc_torch/csrc/ms_deform_attn_bwd.cu",
                replaces="neurips2023_soc_tpu/ops/pallas_msda.py:698",
                max_abs_err=report["encoder bf16"]["err"], bound_ms=bound,
                bound_by=bound_by, **t)


def msda_times() -> None:
    """K1 and K2 alone, timed as check_msda and check_msda_bwd time them, on
    whichever tree this script sits in: it calls only the wrappers' launch
    functions, so a copy of it in an older checkout times that checkout's
    kernels (an A/B in one call)."""
    _build.build_all(["ms_deform_attn_fwd", "ms_deform_attn_bwd"])
    S = sum(h * w for h, w in LEVELS)
    times = {}
    for tag, B, Lq in (("encoder", None, S), ("decoder", None, 20)):
        value, loc, attn = msda_inputs(Lq, LEVELS, torch.bfloat16, False, seed=2, B=B_CLIP)
        times[f"k1_{tag}_ms"] = time_ms(lambda: msda_mod._launch(value, LEVELS, loc, attn),
                                        reps=20)
        value, loc, attn = msda_inputs(Lq, LEVELS, torch.bfloat16, False, seed=12, B=T_TRAIN)
        g = torch.randn(T_TRAIN, Lq, M * D, generator=torch.Generator().manual_seed(2))
        g = g.to("cuda", torch.bfloat16)
        times[f"k2_{tag}_ms"] = time_ms(
            lambda: msda_mod._launch_bwd(value, LEVELS, loc, attn, g), reps=20)
        times[f"k2_{tag}_autograd_ms"] = time_bwd_ms(ms_deform_attn, value, LEVELS, loc,
                                                     attn, g)
    log(json.dumps({"msda_times": times, "tree": str(ROOT)}))


# ---------------------------------------------------------------- K3
def window_geometry(T: int, H: int, W: int, window, shifted: bool):
    """(B_, N, ids) of one Swin block on a (T, H, W) token grid: padded to
    the window, clamped where the grid is smaller (JAX _effective_window),
    region ids when the block is shifted."""
    win = [min(s, w) for s, w in zip((T, H, W), window)]
    shift = [0 if s <= w else w // 2 for s, w in zip((T, H, W), window)]
    Dp, Hp, Wp = (-(-s // w) * w for s, w in zip((T, H, W), win))
    nW = (Dp // win[0]) * (Hp // win[1]) * (Wp // win[2])
    N = win[0] * win[1] * win[2]
    ids = None
    if shifted and any(shift):
        ids = _np_window_region_ids(Dp, Hp, Wp, tuple(win), tuple(shift))
    return nW, N, ids


def wattn_inputs(B_, H, N, ids, dtype, seed, fused=False):
    """Contiguous (B_, H, N, 32) q, k, v; with `fused`, the three strided
    views of one (B_, N, 3, H, 32) qkv buffer that WindowAttention3D passes.
    The bias has the spread of a trained relative-position table (std 1.5),
    not of its 0.02 init, so that a bias read wrongly moves the output far
    beyond the bf16 tolerance."""
    g = torch.Generator().manual_seed(seed)
    dev = torch.device("cuda")
    if fused:
        qkv = torch.randn(B_, N, 3, H, 32, generator=g).to(dev, dtype).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
    else:
        q, k, v = (torch.randn(B_, H, N, 32, generator=g).to(dev, dtype) for _ in range(3))
    bias = 1.5 * torch.randn(H, N, N, generator=g)
    ids_t = None if ids is None else torch.from_numpy(ids).to(dev)
    return q, k, v, bias.to(dev), ids_t


def wattn_bound_ms(q, bias, ids):
    """Least time for the card: q, k, v read once, the output written once
    (all in q's dtype), the f32 bias and int32 ids read once, over HBM
    bandwidth; against 4 N^2 Dh flops per (window, head) (q.k and p.v) over
    the bf16 tensor-core peak."""
    B_, H, N, Dh = q.shape
    nbytes = 4 * q.numel() * q.element_size() + bias.numel() * 4 + (
        0 if ids is None else ids.numel() * 4)
    flops = 4.0 * B_ * H * N * N * Dh
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_TC_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_window_attention() -> dict:
    """K3 against window_attention_ref on the card at the Video-Swin-B
    shapes of a 16 x 360 x 640 clip (token grids 16 x 90 x 160, 16 x 45 x 80,
    16 x 23 x 40 and 16 x 12 x 20, masked and unmasked), a clamped window, a
    2D-Swin window, the largest and smallest N the kernel takes, and B_ = 61
    windows (a prime, so no group of 2 to 60 windows per CTA divides it).
    f32: rtol = atol = 2e-5 (the JAX suite's). bf16: against the plain version
    in f32 on the same bf16-rounded inputs, rtol 0 and atol two bf16 ulps of
    the largest expected magnitude (2 * 2**-7 * max|expected|). Where N > 1,
    a control runs each case again with the bias zeroed on the kernel side and
    raises unless that fails the tolerance. Times K3, SDPA (given the bias
    broadcast over the windows where there is no mask, the bias plus the
    per-window mask where there is) and the bound at the eight stage shapes (20
    back-to-back calls per timing, so the wrapper's host work does not count),
    and their sums over one clip's 24 blocks."""
    win = (8, 7, 7)
    stages = {  # stage: (token grid, heads, blocks per clip, half of them shifted)
        1: ((16, 90, 160), 4, 2), 2: ((16, 45, 80), 8, 2), 3: ((16, 23, 40), 16, 18),
        4: ((16, 12, 20), 32, 2)}
    cases = []  # name, B_, H, (nW, N, ids), dtype, q/k/v as views of a fused qkv buffer
    for s, (grid, H, _) in stages.items():
        nW, N, ids = window_geometry(*grid, win, True)
        cases += [(f"stage {s} masked bf16", nW, H, (nW, N, ids), torch.bfloat16, False),
                  (f"stage {s} unmasked bf16", nW, H, (nW, N, None), torch.bfloat16, False)]
    s3 = window_geometry(16, 23, 40, win, True)
    s4 = window_geometry(16, 12, 20, win, False)
    clamp = window_geometry(4, 23, 40, win, True)  # T = 4 < 8: window (4, 7, 7)
    swin2d = window_geometry(1, 23, 40, (1, 7, 7), True)
    n512 = window_geometry(16, 16, 16, (8, 8, 8), True)
    ragged_ids = np.random.RandomState(0).randint(0, 9, (61, s3[1])).astype(np.int32)
    cases += [
        ("stage 3 masked bf16, fused qkv views", s3[0], 16, s3, torch.bfloat16, True),
        ("stage 3 masked f32", s3[0], 16, s3, torch.float32, False),
        ("stage 3 unmasked f32", s3[0], 16, (s3[0], s3[1], None), torch.float32, False),
        ("stage 4 unmasked f32", s4[0], 32, s4, torch.float32, False),
        ("clamped window N=196 masked bf16, B=2", 2 * clamp[0], 8, clamp, torch.bfloat16,
         False),
        ("2D Swin N=49 masked f32", swin2d[0], 4, swin2d, torch.float32, False),
        ("window (8, 8, 8) N=512 masked bf16", n512[0], 4, n512, torch.bfloat16, False),
        ("N=1 masked bf16", 24, 2, (24, 1, np.zeros((24, 1), np.int32)), torch.bfloat16,
         False),
        ("B_=61 windows N=392 masked bf16", 61, 4, (61, s3[1], ragged_ids), torch.bfloat16,
         False),
    ]
    report = {}
    for i, (name, B_, H, (nW, N, ids), dtype, fused) in enumerate(cases):
        q, k, v, bias, ids_t = wattn_inputs(B_, H, N, ids, dtype, seed=20 + i, fused=fused)
        if fused and _kernel_layout(q, k, v)[0] is not q:
            raise RuntimeError("the fused qkv views were copied before the kernel")
        with torch.no_grad():
            got = window_attention(q, k, v, bias, ids_t)
            torch.cuda.synchronize()
            want = window_attention_ref(q.float(), k.float(), v.float(), bias, ids_t)
        if dtype == torch.float32:
            rtol = atol = 2e-5
        else:
            rtol, atol = 0.0, 2 * 2.0 ** -7 * want.abs().max().item()
        err = (got.float() - want).abs().max().item()
        torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol,
                                   msg=lambda m: f"window attention kernel vs plain, {name}: {m}")
        control = ""
        if N > 1:  # the control: the same comparison with the bias zeroed on the kernel side
            with torch.no_grad():
                unbiased = window_attention(q, k, v, torch.zeros_like(bias), ids_t)
            miss = ((unbiased.float() - want).abs() / (atol + rtol * want.abs())).max().item()
            if miss <= 1.0:
                raise RuntimeError(f"window attention {name}: the tolerance cannot see the "
                                   f"bias (zeroed, error {miss:.3f} of the tolerance)")
            control = f"; bias zeroed: {miss:.1f}x the tolerance"
            del unbiased
        log(f"[kernels] window_attention {name} {(B_, H, N, 32)}: max_abs_err {err:.3e} "
            f"(rtol {rtol}, atol {atol:.3e}){control}")
        report[name] = {"err": err, "inputs": (q, k, v, bias, ids_t)}
        del got, want
    timed = {}
    clip = {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for s, (_, _, blocks) in stages.items():
        for mask in ("masked", "unmasked"):
            name = f"stage {s} {mask} bf16"
            q, k, v, bias, ids_t = report[name]["inputs"]
            B_, H, N, _ = q.shape
            # unmasked: the (1, H, N, N) bias, broadcast over the windows; masked: the bias
            # plus the region mask, which differs per window, as a (B_, H, N, N) tensor
            full, what = bias[None].to(q.dtype), "(1, H, N, N) bias"
            if ids_t is not None:
                nW = ids_t.shape[0]
                full = (bias[None, None] + mask_from_ids(ids_t)[None, :, None]).to(q.dtype)
                full = full.expand(B_ // nW, nW, H, N, N).reshape(B_, H, N, N)
                what = "(B_, H, N, N) bias + mask"
            with torch.no_grad():
                t = {"ms": time_ms(lambda: window_attention(q, k, v, bias, ids_t),
                                   iters=10, reps=20),
                     "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                         q, k, v, attn_mask=full), iters=10, reps=20)}
                if s in (1, 3) and mask == "masked":
                    t["plain_ms"] = time_ms(lambda: window_attention_ref(q, k, v, bias, ids_t),
                                            iters=10)
            del full
            t["bound_ms"], t["bound_by"] = wattn_bound_ms(q, bias, ids_t)
            for key in clip:
                clip[key] += blocks // 2 * t[key]
            log(f"[kernels] window_attention {name} {(B_, H, N, 32)}: kernel {t['ms']:.4f} ms, "
                + (f"plain {t['plain_ms']:.4f} ms, " if "plain_ms" in t else "")
                + f"SDPA ({what}) {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}, bf16 tensor-core peak for operations)")
            timed[name] = t
    log(f"[kernels] window_attention per 16 x {HEIGHT} x {WIDTH} clip (sum of launches x time "
        f"over its {K3_PER_CLIP} blocks, half of them masked): kernel {clip['ms']:.4f} ms, "
        f"SDPA {clip['library_ms']:.4f} ms, bound {clip['bound_ms']:.4f} ms")
    return dict(name="window_attention_fwd", route="cuda",
                note="bf16: tensor cores (mma.sync m16n8k16); f32: CUDA cores",
                source="neurips2023_soc_torch/csrc/window_attention_fwd.cu",
                replaces="neurips2023_soc_tpu/ops/window_attention.py:112",
                max_abs_err=report["stage 3 masked bf16"]["err"], **timed["stage 3 masked bf16"])


# ---------------------------------------------------------------- e2e
def inference_config(attn_impl: str):
    return load_config(ROOT / "configs" / "refer_youtube_vos.yaml", overrides={
        "backbone": "video-swin-b", "compute_dtype": "bfloat16", "swin_attn_impl": attn_impl})


def inference_inputs():
    rng = np.random.RandomState(0)
    videos = [rng.randint(0, 256, (T_CLIP, HEIGHT, WIDTH, 3)).astype(np.uint8)
              for _ in range(NUM_VIDEOS)]
    return videos, ["a person riding a bike", "the dog on the left", "a red car turning"]


def check_masks(results) -> None:
    for (masks,) in results:
        if masks.shape != (T_CLIP, HEIGHT, WIDTH) or masks.dtype != np.uint8:
            raise RuntimeError(f"masks {masks.shape} {masks.dtype}")
        if not set(np.unique(masks).tolist()) <= {0, 1}:
            raise RuntimeError("masks hold values other than 0 and 1")


def clip_timings(model, video, text, tokenizer, tag: str) -> dict:
    """Finite logits of one clip forward, and CUDA-event times of the whole
    forward, the backbone and the head."""
    pad = torch.zeros(T_CLIP, 1, HEIGHT, WIDTH, dtype=torch.bool, device="cuda")
    px = torch.from_numpy(video).cuda()[:, None].float() / 255.0
    ids, msk = (torch.from_numpy(a).cuda() for a in tokenizer([text]))
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
    log(f"[{tag}] logits finite; clip forward {clip_ms:.2f} ms on the device = "
        f"{1e3 / clip_ms:.3f} clips/s = {device_fps:.2f} frames/s (backbone "
        f"{backbone_ms:.2f} ms, head {head_ms:.2f} ms); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dict(device_fps=device_fps, backbone_ms=backbone_ms, clip_ms=clip_ms)


def main_path() -> dict:
    cfg = inference_config("xla")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[e2e] built SOC video-swin-b bf16 ({n_params / 1e6:.1f} M params) in "
        f"{time.perf_counter() - t0:.1f} s")
    engine = InferenceEngine(model, text_encoder_type=cfg.text_encoder_type,
                             text_bucket=cfg.text_bucket, size_buckets=((HEIGHT, WIDTH),))
    videos, texts = inference_inputs()
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    engine.infer_video(videos[0], texts[0])  # warm-up (cuDNN, allocator)
    torch.cuda.synchronize()
    log(f"[e2e] warm-up video in {time.perf_counter() - t0:.1f} s")

    items = [dict(frames=v, texts=[t]) for v, t in zip(videos, texts)]
    reset_counters()
    t0 = time.perf_counter()
    results = list(engine.infer_videos(items))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = ms_deform_attn.launches, ms_deform_attn.plain_calls
    if launches != MSDA_PER_CLIP * NUM_VIDEOS:
        raise RuntimeError(f"MSDA kernel launched {launches} times over {NUM_VIDEOS} "
                           f"clips, expected {MSDA_PER_CLIP} per clip")
    if plain != 0 or ms_deform_attn.bwd_launches or ms_deform_attn.plain_bwd_calls:
        raise RuntimeError(f"the inference path called the plain MSDA {plain} times "
                           f"or ran a backward")
    if window_attention.launches or window_attention.plain_calls \
            or window_attention_torch.calls != K3_PER_CLIP * NUM_VIDEOS:
        raise RuntimeError("swin_attn_impl xla: expected only window_attention_torch, "
                           f"{K3_PER_CLIP} calls per clip")
    check_masks(results)
    engine_fps = NUM_VIDEOS * T_CLIP / wall
    log(f"[e2e] infer_videos: {NUM_VIDEOS} videos x {T_CLIP} frames in {wall:.3f} s "
        f"= {engine_fps:.2f} frames/s; MSDA launches {launches}, plain calls {plain}; "
        f"mask foreground share {np.mean([m.mean() for (m,) in results]):.4f}")

    timings = clip_timings(model, videos[0], texts[0], engine.tokenizer, "e2e")
    return dict(launches=launches, engine_fps=engine_fps,
                masks=[m for (m,) in results], **timings)


def k3_path(e2e: dict) -> dict:
    """Phase e2e's workload and weights with swin_attn_impl: pallas, through
    EnginePool (one engine on card 0) and run_videos_pipelined; raises unless
    every clip ran exactly 24 K3 and 6 K1 launches and nothing ran the plain
    window attention (either version) or the plain MSDA."""
    cfg = inference_config("pallas")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda", seed=0)
    pool = EnginePool(model, devices=[torch.device("cuda", 0)],
                      text_encoder_type=cfg.text_encoder_type, text_bucket=cfg.text_bucket,
                      size_buckets=((HEIGHT, WIDTH),))
    engine = pool.engines[0]
    if engine.model is not model:
        raise RuntimeError("EnginePool copied a model already on its card")
    videos, texts = inference_inputs()
    t0 = time.perf_counter()
    engine.infer_video(videos[0], texts[0])  # warm-up
    torch.cuda.synchronize()
    log(f"[e2e-k3] EnginePool of {len(pool.engines)} engine; warm-up video in "
        f"{time.perf_counter() - t0:.1f} s")

    def counts():
        return dict(k3=window_attention.launches, k3_plain=window_attention.plain_calls,
                    xla_attn=window_attention_torch.calls, k1=ms_deform_attn.launches,
                    k1_plain=ms_deform_attn.plain_calls)

    def expect(clips: int, tag: str) -> dict:
        got = counts()
        want = dict(k3=K3_PER_CLIP * clips, k3_plain=0, xla_attn=0,
                    k1=MSDA_PER_CLIP * clips, k1_plain=0)
        if got != want:
            raise RuntimeError(f"{tag}: kernel counts {got}, expected {want}")
        return got

    items = [dict(frames=v, text=t) for v, t in zip(videos, texts)]
    reset_counters()
    t0 = time.perf_counter()
    results = run_videos_pipelined(pool, items,
                                   lambda it: dict(frames=it["frames"], texts=[it["text"]]),
                                   lambda it, res: res)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = expect(NUM_VIDEOS, "run_videos_pipelined")
    check_masks(results)
    engine_fps = NUM_VIDEOS * T_CLIP / wall
    per_video = [float(np.mean(m != e)) for (m,), e in zip(results, e2e["masks"])]
    differ = float(np.mean(per_video))
    log(f"[e2e-k3] run_videos_pipelined: {NUM_VIDEOS} videos x {T_CLIP} frames in "
        f"{wall:.3f} s = {engine_fps:.2f} frames/s; counts {got}; mask pixels that differ "
        f"from phase e2e (xla window attention, same weights): {differ:.6f} (0.003710 when "
        f"K3 kept p in f32 on the CUDA cores), per video "
        f"{', '.join(f'{d:.6f}' for d in per_video)}")

    # one video with YUV420 input, one with uint8 probabilities
    yuv = InferenceEngine(engine.model, text_encoder_type=cfg.text_encoder_type,
                          text_bucket=cfg.text_bucket, size_buckets=((HEIGHT, WIDTH),),
                          pixel_format="yuv420")
    reset_counters()
    check_masks([(yuv.infer_video(videos[1], texts[1]),)])
    expect(1, "pixel_format yuv420")
    u8 = InferenceEngine(engine.model, text_encoder_type=cfg.text_encoder_type,
                         text_bucket=cfg.text_bucket, size_buckets=((HEIGHT, WIDTH),),
                         probs_dtype="uint8")
    reset_counters()
    probs = u8.infer_video(videos[2], texts[2], return_probs=True)
    expect(1, "probs_dtype uint8")
    steps = probs * 255.0
    if probs.shape != (T_CLIP, HEIGHT, WIDTH) or probs.dtype != np.float32 \
            or probs.min() < 0.0 or probs.max() > 1.0 \
            or np.abs(steps - np.round(steps)).max() > 1e-3:
        raise RuntimeError(f"uint8 probabilities: {probs.shape} {probs.dtype} in "
                           f"[{probs.min()}, {probs.max()}]")
    log(f"[e2e-k3] yuv420 video: masks {(T_CLIP, HEIGHT, WIDTH)} in {{0, 1}}; uint8 "
        f"probabilities: float32 {probs.shape} in [{probs.min():.4f}, {probs.max():.4f}], "
        f"multiples of 1/255; 24 K3 + 6 K1 launches each")

    timings = clip_timings(engine.model, videos[0], texts[0], engine.tokenizer, "e2e-k3")
    profile_backbone(engine.model, videos[0], "e2e-k3")

    # after the timed clip, whose peak memory it would raise: the model's own K3 calls of
    # one clip, each held against the plain version in f32 (this checks the backbone's
    # strides and region ids; its 0.02-std init bias is too small for the tolerance to see,
    # which the kernel phase's trained-size bias and its control cover)
    ratios = []

    def checked(q, k, v, bias, ids):
        out = window_attention(q, k, v, bias, ids)
        want = window_attention_ref(q.float(), k.float(), v.float(), bias, ids)
        ratios.append((out.float() - want).abs().max().item()
                      / (2 * 2.0 ** -7 * want.abs().max().item()))
        return out

    # and the clip's 6 K1 calls, each held against the plain version in f32 on the same
    # inputs at the kernel phase's tolerance
    k1_ratios = []
    launch = msda_mod._launch

    def checked_k1(value, spatial_shapes, loc, attn, *args, **kwargs):
        out = launch(value, spatial_shapes, loc, attn, *args, **kwargs)
        want = ms_deform_attn_torch(value.float(), spatial_shapes, loc, attn.float())
        tol = fwd_tol(value.dtype)
        k1_ratios.append(miss_ratio(out, want, tol, tol))
        return out

    try:
        video_swin.window_attention = checked
        msda_mod._launch = checked_k1
        engine.infer_video(videos[0], texts[0])
    finally:
        video_swin.window_attention = window_attention
        msda_mod._launch = launch
    if len(ratios) != K3_PER_CLIP or max(ratios) > 1.0:
        raise RuntimeError(f"K3 on the model's inputs: {len(ratios)} calls, error / tolerance "
                           f"up to {max(ratios):.3f}")
    if len(k1_ratios) != MSDA_PER_CLIP or max(k1_ratios) > 1.0:
        raise RuntimeError(f"K1 on the model's inputs: {len(k1_ratios)} calls, error / "
                           f"tolerance {k1_ratios}")
    log(f"[e2e-k3] K3 on the model's {len(ratios)} inputs of video 0: error up to "
        f"{max(ratios):.3f} of the two-ulp tolerance against the plain version in f32; K1 on "
        f"its {len(k1_ratios)} inputs: error / tolerance "
        f"{', '.join(f'{r:.3f}' for r in k1_ratios)}")
    return dict(launches=got["k3"], k1_launches=got["k1"], engine_fps=engine_fps,
                differ=differ, **timings)


def profile_backbone(model, video, tag: str, top: int = 12) -> None:
    """One torch.profiler pass over the backbone of one clip (after a warm
    call): device time by kernel, the top `top` kernels with their share,
    and the device-busy share of the CUDA-event span around the pass."""
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(T_CLIP, 1, HEIGHT, WIDTH, dtype=torch.bool, device="cuda")
    px = torch.from_numpy(video).cuda()[:, None].float() / 255.0
    with torch.no_grad():
        model.backbone_features(px, pad)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ev[0].record()
            model.backbone_features(px, pad)
            ev[1].record()
            torch.cuda.synchronize()
    span = ev[0].elapsed_time(ev[1])
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    if busy <= 0:
        raise RuntimeError(f"[{tag}] the profiler recorded no device kernel")
    log(f"[{tag}] profile of one backbone pass: {span:.2f} ms (CUDA events), device busy "
        f"{busy:.2f} ms in {len(by_name)} kernels ({busy / span:.1%} of the span); top kernels:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"[{tag}]   {ms:8.3f} ms {ms / busy:6.1%}  {name[:110]}")


def train_path(smi: str, out_dir: str) -> dict:
    """The port's Trainer at full width on synthetic clips, writing its log
    and checkpoints under `out_dir`; raises unless every loss is finite, the
    gradient norm finite and positive, backbone and main parameters moved,
    the frozen text encoder stayed bit-identical, each step ran 6 K1 and 6 K2
    launches and no plain MSDA, and the checkpoint reads back equal."""
    cfg = load_config(ROOT / "configs" / "refer_youtube_vos.yaml", overrides={
        "backbone": "video-swin-b", "compute_dtype": "bfloat16", "output_dir": out_dir,
        "epochs": 1})
    if cfg.window_size != T_TRAIN or cfg.use_checkpoint:
        raise RuntimeError("the training config changed: window_size "
                           f"{cfg.window_size}, use_checkpoint {cfg.use_checkpoint}")
    tok = build_tokenizer(cfg.text_encoder_type, cfg.text_bucket)
    ds = SyntheticRVOSDataset(num_samples=TRAIN_STEPS, num_frames=T_TRAIN,
                              frame_size=(HEIGHT, WIDTH), seed=0)

    def batches(epoch):
        return iterate_batches(ds, 1, tok, seed=epoch, size_buckets=((HEIGHT, WIDTH),))

    t0 = time.perf_counter()
    trainer = Trainer(cfg, batches, steps_per_epoch=TRAIN_STEPS)
    state = trainer.init_state()
    model = trainer.model
    log(f"[train] built SOC video-swin-b bf16 trainer in {time.perf_counter() - t0:.1f} s; "
        f"drop path {model.backbone[0].body.layers[-1].blocks[-1].drop_path:.2f} (last "
        f"block), dropout {cfg.DeformTransformer['dropout']}")
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}

    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: getattr(ms_deform_attn, k) for k in
              ("launches", "bwd_launches", "plain_calls", "plain_bwd_calls")}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if counts != {"launches": MSDA_PER_CLIP * TRAIN_STEPS,
                  "bwd_launches": MSDA_PER_CLIP * TRAIN_STEPS,
                  "plain_calls": 0, "plain_bwd_calls": 0}:
        raise RuntimeError(f"MSDA counts over {TRAIN_STEPS} steps: {counts}; expected "
                           f"{MSDA_PER_CLIP} forward and backward launches per step")
    hist = trainer.history
    if len(hist) != TRAIN_STEPS:
        raise RuntimeError(f"{len(hist)} steps ran, expected {TRAIN_STEPS}")
    for i, h in enumerate(hist):
        bad = [k for k, v in h.items() if not np.isfinite(v)]
        if bad or not h["grad_norm"] > 0:
            raise RuntimeError(f"step {i}: non-finite {bad} or grad_norm {h['grad_norm']}")
    after = model.state_dict()
    moved = {g: any(not torch.equal(after[k], v) for k, v in before.items()
                    if k.startswith(prefix))
             for g, prefix in (("backbone", "backbone."), ("text", "text_encoder."))}
    moved["main"] = any(not torch.equal(after[k], v) for k, v in before.items()
                        if not k.startswith(("backbone.", "text_encoder.")))
    if not (moved["backbone"] and moved["main"]) or moved["text"]:
        raise RuntimeError(f"parameters moved: {moved}; expected backbone and main, "
                           "not the frozen text encoder")

    epoch = trainer.ckpt.latest_epoch()
    saved = trainer.ckpt.restore(epoch, map_location="cuda")
    for k, v in after.items():
        if not torch.equal(saved["model"][k], v):
            raise RuntimeError(f"checkpoint differs from the model at {k}")
    if saved["step"] != TRAIN_STEPS or saved["optimizer"]["count"] != TRAIN_STEPS:
        raise RuntimeError(f"checkpoint step {saved['step']}")
    del saved

    step_ms = statistics.median(h["step_time_s"] for h in hist[1:]) * 1e3
    log(f"[train] {TRAIN_STEPS} steps of 1 x {T_TRAIN} x {HEIGHT} x {WIDTH} in {wall:.2f} s; "
        f"losses {[round(h['loss'], 4) for h in hist]}; grad_norm "
        f"{[round(h['grad_norm'], 4) for h in hist]}")
    log(f"[train] MSDA counts {counts}; parameters moved {moved}; checkpoint epoch {epoch} "
        f"read back equal")

    # one more step split by CUDA events: forward + criterion, backward,
    # optimizer (the trainer's step without its host reads)
    batch = device_batch(next(iter(batches(1))), torch.device("cuda"))
    rng = torch.Generator(device="cuda")
    split = []
    for i in range(3):
        rng.manual_seed(i)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        out = model(batch["pixels"], batch["pad_mask"], batch["text_ids"],
                    batch["text_mask"], sample_sizes=batch["sample_sizes"], training=True,
                    rng=rng)
        loss = total_loss(compute_criterion(out, {k: batch[k] for k in TARGET_KEYS},
                                            trainer.crit_cfg), trainer.crit_cfg)
        ev[1].record()
        del out
        loss.backward()
        ev[2].record()
        state.optimizer.apply_gradients()
        ev[3].record()
        ev[3].synchronize()
        split.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
    fwd, bwd, opt = (statistics.median(c) for c in zip(*split))

    # one more forward and backward: the step's 6 K2 calls, each held against the plain
    # backward in f32 on the same inputs at the kernel phase's tolerances
    k2_ratios = []
    launch_bwd = msda_mod._launch_bwd

    def checked_k2(value, spatial_shapes, loc, attn, grad_out, *args, **kwargs):
        got = launch_bwd(value, spatial_shapes, loc, attn, grad_out, *args, **kwargs)
        want = ms_deform_attn_torch_bwd(value.float(), spatial_shapes, loc, attn.float(),
                                        grad_out.float())
        k2_ratios.append(max(miss_ratio(x, w, *bwd_tols(x, w)) for x, w in zip(got, want)))
        return got

    rng.manual_seed(3)
    try:
        msda_mod._launch_bwd = checked_k2
        out = model(batch["pixels"], batch["pad_mask"], batch["text_ids"],
                    batch["text_mask"], sample_sizes=batch["sample_sizes"], training=True,
                    rng=rng)
        total_loss(compute_criterion(out, {k: batch[k] for k in TARGET_KEYS},
                                     trainer.crit_cfg), trainer.crit_cfg).backward()
    finally:
        msda_mod._launch_bwd = launch_bwd
    del out
    model.zero_grad(set_to_none=True)
    if len(k2_ratios) != MSDA_PER_CLIP or max(k2_ratios) > 1.0:
        raise RuntimeError(f"K2 on the model's inputs: {len(k2_ratios)} calls, error / "
                           f"tolerance {k2_ratios}")
    log(f"[train] K2 on the {len(k2_ratios)} inputs of one step: error / tolerance "
        f"{', '.join(f'{r:.3f}' for r in k2_ratios)} (worst of d_value, d_loc, d_attn)")
    log(f"[train] {smi}: step {step_ms:.2f} ms (median of steps 2-{TRAIN_STEPS}, host clock, "
        f"loss read every step) = {1e3 / step_ms:.3f} samples/s; CUDA events: forward + "
        f"criterion {fwd:.2f} ms, backward {bwd:.2f} ms, optimizer {opt:.2f} ms; peak "
        f"memory {peak:.2f} GiB")
    return dict(bwd_launches=counts["bwd_launches"], fwd_launches=counts["launches"],
                step_ms=step_ms)


def small_reference(attn_impl: str) -> None:
    """A small float32 SOC on the card against the same weights on the CPU
    (plain versions: window_attention_torch for xla, window_attention_ref
    for pallas)."""
    kw = dict(backbone_name="video-swin-t", d_model=64, num_queries=5,
              dim_feedforward=128, enc_layers=1, dec_layers=2, voc_enc_layers=1,
              voc_dec_layers=1, text_encoder_type="roberta-tiny", swin_attn_impl=attn_impl)
    cpu = init_weights(SOC(**kw), torch.Generator().manual_seed(1)).eval()
    gpu = init_weights(SOC(**kw), torch.Generator().manual_seed(1)).cuda().eval()
    rng = np.random.RandomState(1)
    px = torch.from_numpy(rng.randn(4, 2, 48, 64, 3).astype(np.float32))
    pad = torch.zeros(4, 2, 48, 64, dtype=torch.bool)
    pad[:, 1, 40:] = True
    ids = torch.from_numpy(rng.randint(3, 1000, (2, 8)).astype(np.int32))
    msk = torch.ones(2, 8, dtype=torch.int32)
    reset_counters()
    with torch.no_grad():
        want = cpu(px, pad, ids, msk)
        got = gpu(px.cuda(), pad.cuda(), ids.cuda(), msk.cuda())
    blocks = 12  # video-swin-t: 2 + 2 + 6 + 2
    expected = {"xla": (0, 0, 2 * blocks), "pallas": (blocks, blocks, 0)}[attn_impl]
    seen = (window_attention.launches, window_attention.plain_calls,
            window_attention_torch.calls)
    if seen != expected:
        raise RuntimeError(f"small SOC {attn_impl}: window attention (kernel, ref, torch) "
                           f"calls {seen}, expected {expected}")
    for k in ("pred_masks", "pred_cls", "pred_boxes", "pred_logit"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-3, atol=1e-3,
                                   msg=lambda m: f"small SOC {attn_impl} cuda vs cpu, {k}: {m}")
    log(f"[small] SOC video-swin-t d_model 64 f32, swin_attn_impl {attn_impl}: card == CPU "
        f"within 1e-3 (window attention kernel / ref / torch calls {seen})")


def main(argv) -> int:
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

    if argv == ["--msda-times"]:
        msda_times()
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv} (none, or --msda-times)", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[build] {', '.join(p.name for p in built.values())} in "
        f"{time.perf_counter() - t0:.1f} s")

    k1 = check_msda()
    k2 = check_msda_bwd()
    k3 = check_window_attention()
    e2e = main_path()
    k1["launches"] = e2e["launches"]
    log(f"[e2e] {smi}: device {e2e['device_fps']:.2f} frames/s, engine "
        f"{e2e['engine_fps']:.2f} frames/s, backbone {e2e['backbone_ms']:.2f} ms "
        f"(Video-Swin-B bf16, 16 x {HEIGHT} x {WIDTH}, swin_attn_impl xla)")
    e2e_k3 = k3_path(e2e)
    del e2e["masks"]
    k3["launches"] = e2e_k3["launches"]
    log(f"[e2e-k3] {smi}: device {e2e_k3['device_fps']:.2f} frames/s, engine "
        f"{e2e_k3['engine_fps']:.2f} frames/s, backbone {e2e_k3['backbone_ms']:.2f} ms "
        f"(swin_attn_impl pallas) beside phase e2e's {e2e['device_fps']:.2f} / "
        f"{e2e['engine_fps']:.2f} frames/s, {e2e['backbone_ms']:.2f} ms; masks differ on "
        f"{e2e_k3['differ']:.6f} of the pixels")
    with tempfile.TemporaryDirectory(prefix="soc_train_") as out_dir:
        train = train_path(smi, out_dir)
    k2["launches"] = train["bwd_launches"]
    small_reference("xla")
    small_reference("pallas")

    log(smi)
    keys = ("name", "route", "note", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in (k1, k2, k3)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
