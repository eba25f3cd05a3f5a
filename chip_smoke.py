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
               heads), P = 3 (the run-time point loop), D = 24, the encoder
               at D = 64 (K2's plan then needs more than the 48 KB default of
               shared memory: the per-card raised limit) and the A2D training
               step's encoder call (value (16, 3825, 8, 32), bf16, timed beside
               its bound), each on the route its
               shape takes on this card (fwd_route / bwd_route: vec, or scalar
               at D = 24), every route in f32 and in bf16.
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
               Control: the bf16 encoder cases (D = 32 and 64) again with the
               last point of every level zeroed in attn on the kernel side must
               fail (K1's output; K2's d_value and d_loc). K1 and K2 are timed as 20
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
               one more step whose 6 K1 and 6 K2 calls are each held against
               the plain versions in f32 on the same inputs (the kernel
               phase's tolerances).
     train-a2d — cli/main.run, the training CLI's body, with
               configs/a2d_sentences.yaml (Video-Swin-T, roberta-base frozen,
               d_model 256, 3+3 deformable layers, VOC 3+3, bf16, batch 2 of
               8-frame 320 x 576 windows, 4 loader threads) on 8 synthetic
               centre-frame-annotated clips (valid_indices on): `train` for one
               epoch of 4 steps with the per-epoch A2D evaluator over 4 synthetic
               clips, `resume_train` from the written checkpoint for a second
               epoch, `test` on a reference .pth.tar of the epoch-2 weights
               (strict load) whose metrics must equal the epoch's logged ones
               exactly; every loss finite, grad norm finite and positive,
               backbone and main parameters moved, the frozen text encoder
               bit-identical, exactly 6 K1 and 6 K2 launches per step and 6 K1
               per evaluation forward, no plain MSDA and no K3, every mAP and
               P@ metric in [0, 1], best by mAP; one step's 6 K1 and 6 K2 calls
               held against the plain versions in f32 (the kernel phase's
               tolerances).
     pretrain — cli/main_pretrain.run with configs/refcoco_pretrain.yaml
               (batch 8 of single 360 x 640 frames, T = 1) on 16 synthetic frames
               (2 steps) with build_pretrain_evaluator over one synthetic val
               split of 4 frames: the same checks, best by mean_mask_mAP.
               Both print step ms, samples/s, the CUDA-event split of a step,
               peak memory and the evaluator's ms per sample.
  6. small   — a small SOC in float32 on the card against the same model on
               the CPU (plain versions), as the reference on a small input,
               with swin_attn_impl xla and pallas, and at T = 1 (xla).
  7. davis   — Ref-DAVIS-17 inference as cli/infer_davis.py runs it, at
               configs/davis.yaml's widths (Video-Swin-T, roberta-base,
               d_model 256, 3+3 deformable layers, bf16, seeded random init)
               with swin_attn_impl: pallas: one synthetic video of 80 x 480 x
               854 uint8 frames (resized on the card to 360 x 640), 2 objects,
               4 expressions each, through davis_videos / item_fn /
               merge_annotators over run_videos_pipelined with per-chunk
               trajectories and probabilities (chunks of 64 + 16 frames):
               exactly 12 K3 per backbone pass and 6 K1 per (chunk,
               expression), no plain call; index masks (80, 480, 854) in
               {0, 1, 2}; J&F of each annotation variant against the synthetic
               ground truth (evaluation/davis.py) finite and in range; each K3
               and K1 call of the first chunk held against the plain version in
               f32; K3 at Video-Swin-T's stage shapes (heads 3 to 24, a trained
               table's bias spread) held against the plain version in f32 with
               the zeroed-bias control, and timed beside SDPA.
  8. a2d-eval — build_a2d_evaluator at configs/a2d_sentences.yaml's widths
               (Video-Swin-T, 8-frame windows, 320 x 576, bf16) over 8
               centre-frame-annotated SyntheticRVOSDataset samples: every mAP
               and P@ metric finite and in [0, 1], 6 K1 per forward, one
               forward's 6 K1 calls held against the plain version in f32, and
               a2d_device_step on the card against the CPU on one forward's
               outputs (scores within 1e-6, masks equal on at least 99.99 % of
               the pixels).
Every kernel counter is set to 0 just before each path is driven and read
just after. `python3 chip_smoke.py --msda-times` only times K1 and K2 at the
path's shapes, and `--train-times` only runs phase train (a copy of this
script in an older checkout runs that checkout's code: an A/B in one chip
call). The second-to-last lines are the card's name/power limit and a
JSON object of the kernels; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import ctypes
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
# the A2D training pyramid at 320 x 576; its batch is 2 clips of 8 frames
A2D_LEVELS = ((40, 72), (20, 36), (10, 18), (5, 9))
B_A2D = 16
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
    # K2's 64-group plan needs 53,248 bytes of shared memory at D = 64, above the 48 KB
    # default: the raised per-card limit
    ("D=64 encoder f32", "vec", sum(h * w for h, w in LEVELS), LEVELS, torch.float32, False,
     64, P),
    ("D=64 encoder bf16", "vec", sum(h * w for h, w in LEVELS), LEVELS, torch.bfloat16,
     False, 64, P),
    # the A2D training step's encoder call: value (16, 3825, 8, 32) for K1 and K2
    ("A2D encoder bf16", "vec", sum(h * w for h, w in A2D_LEVELS), A2D_LEVELS, torch.bfloat16,
     False, D, P),
]


def case_batch(levels, kernel: str) -> int:
    """B of a kernel case: the clip (K1) or the training step (K2) at the
    main path's pyramid, 16 at the A2D pyramid, 2 elsewhere."""
    if levels == A2D_LEVELS:
        return B_A2D
    if levels == LEVELS:
        return B_CLIP if kernel == "k1" else T_TRAIN
    return 2

CONTROL_CASES = ("encoder bf16", "D=64 encoder bf16")  # with the drop-a-point control


def k2_vec_plan(D: int, P: int, groups: int) -> tuple:
    """(groups per CTA, dynamic shared memory) of the plan K2's library takes for a vec
    launch on this card (csrc/ms_deform_attn_bwd.cu:msda_bwd_vec_plan)."""
    fn = _build.load("ms_deform_attn_bwd").msda_bwd_vec_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    plan = (ctypes.c_int * 2)()
    err = fn(D, P, groups, plan)
    if err != 0:
        raise RuntimeError(f"K2 takes no vec plan at D={D}, P={P}, {groups} groups "
                           f"(code {err})")
    return plan[0], plan[1]


def miss_ratio(got, want, rtol, atol) -> float:
    """max |got - want| / (atol + rtol |want|): above 1 fails the tolerance."""
    return ((got.float() - want).abs() / (atol + rtol * want.abs())).max().item()


def fwd_tol(dtype) -> float:
    return 1e-5 if dtype == torch.float32 else 1.6e-2


def check_msda() -> dict:
    """K1 against the plain version on every case of MSDA_CASES (B = 16 at the
    path's pyramid, B = 2 elsewhere), each on the route its shape takes. A
    control reruns each case of CONTROL_CASES with the last point of every level
    zeroed in attn on the kernel side and raises unless that fails the
    tolerance. Times the kernel as 20 back-to-back calls per event pair."""
    report = {}
    for i, (name, route, Lq, levels, dtype, uniform, dim, pts) in enumerate(MSDA_CASES):
        if msda_mod.fwd_route(dim, pts) != route:
            raise RuntimeError(f"K1 {name}: the shape takes route "
                               f"{msda_mod.fwd_route(dim, pts)}, expected {route}")
        B = case_batch(levels, "k1")
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
        if name in CONTROL_CASES:  # one dropped sample per level must show
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
    av, al, aa, alevels = report["A2D encoder bf16"]["inputs"]
    a2d_ms = time_ms(lambda: ms_deform_attn(av, alevels, al, aa), reps=20)
    a2d_bound, a2d_by = msda_bound_ms(av, alevels, al, aa)
    log(f"[kernels] ms_deform_attn A2D encoder bf16 {tuple(av.shape)} Lq={al.shape[1]}: kernel "
        f"{a2d_ms:.4f} ms (20 calls per timing), bound {a2d_bound:.4f} ms ({a2d_by})")
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
    each on the route its shape takes; the control of each case of CONTROL_CASES
    drops the last point of each level from attn on the kernel side and must fail. Times
    the kernel as 20 back-to-back launches per event pair."""
    report = {}
    for i, (name, route, Lq, levels, dtype, uniform, dim, pts) in enumerate(MSDA_CASES):
        if msda_mod.bwd_route(dim, pts, "cuda") != route:
            raise RuntimeError(f"K2 {name}: the shape takes route "
                               f"{msda_mod.bwd_route(dim, pts, 'cuda')} on this card, "
                               f"expected {route}")
        B = case_batch(levels, "k2")
        plan = ""
        if route == "vec":
            G, smem = k2_vec_plan(dim, pts, B * Lq * M)
            if dim == 64 and smem <= 48 * 1024:
                raise RuntimeError(f"K2 {name}: the plan needs {smem} bytes of shared memory, "
                                   "not above the 48 KB default")
            plan = (f", {G} groups per CTA, {smem} of the card's "
                    f"{msda_mod.card_smem_room(torch.device('cuda'))} bytes of dynamic shared "
                    f"memory")
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
            log(f"[kernels] ms_deform_attn_bwd {name} ({route} route{plan}, B={B}, D={dim}, "
                f"P={pts}) {oname} {x.dtype}: max_abs_err {err:.3e} (rtol {rtol}, "
                f"atol {atol:.3e})")
        if name in CONTROL_CASES:  # one dropped sample per level must show
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
    av, al, aa, alevels, ag = report["A2D encoder bf16"]["inputs"]
    a2d_ms = time_ms(lambda: msda_mod._launch_bwd(av, alevels, al, aa, ag), reps=20)
    a2d_bound, a2d_by = msda_bwd_bound_ms(av, alevels, al, aa)
    log(f"[kernels] ms_deform_attn_bwd A2D encoder bf16 {tuple(av.shape)} Lq={al.shape[1]}: "
        f"kernel {a2d_ms:.4f} ms (20 launches per timing), bound {a2d_bound:.4f} ms ({a2d_by})")
    for name in ("D=64 encoder f32", "D=64 encoder bf16"):
        v64, l64, a64, _, g64 = report[name]["inputs"]
        ms64 = time_ms(lambda: msda_mod._launch_bwd(v64, LEVELS, l64, a64, g64), reps=20)
        b64, by64 = msda_bwd_bound_ms(v64, LEVELS, l64, a64)
        log(f"[kernels] ms_deform_attn_bwd {name} {tuple(v64.shape)}: kernel {ms64:.4f} ms "
            f"(20 launches per timing), bound {b64:.4f} ms ({by64})")
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


def time_k3(q, k, v, bias, ids_t, plain: bool = False) -> dict:
    """K3, SDPA and the bound at one shape (20 back-to-back calls per timing);
    with `plain`, the plain version too. SDPA is given, where there is no
    mask, the (1, H, N, N) bias broadcast over the windows; where there is,
    the bias plus the region mask, which differs per window, as a (B_, H, N, N)
    tensor."""
    B_, H, N, _ = q.shape
    full, what = bias[None].to(q.dtype), "(1, H, N, N) bias"
    if ids_t is not None:
        nW = ids_t.shape[0]
        full = (bias[None, None] + mask_from_ids(ids_t)[None, :, None]).to(q.dtype)
        full = full.expand(B_ // nW, nW, H, N, N).reshape(B_, H, N, N)
        what = "(B_, H, N, N) bias + mask"
    with torch.no_grad():
        t = {"ms": time_ms(lambda: window_attention(q, k, v, bias, ids_t), iters=10, reps=20),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                 q, k, v, attn_mask=full), iters=10, reps=20)}
        if plain:
            t["plain_ms"] = time_ms(lambda: window_attention_ref(q, k, v, bias, ids_t), iters=10)
    del full
    t["bound_ms"], t["bound_by"] = wattn_bound_ms(q, bias, ids_t)
    t["sdpa_mask"] = what
    return t


def log_k3_time(tag: str, name: str, shape, t: dict) -> None:
    log(f"[{tag}] window_attention {name} {tuple(shape)}: kernel {t['ms']:.4f} ms, "
        + (f"plain {t['plain_ms']:.4f} ms, " if "plain_ms" in t else "")
        + f"SDPA ({t['sdpa_mask']}) {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}, bf16 tensor-core peak for operations)")


def k3_bias_control(name, q, k, v, bias, ids_t, want, rtol, atol) -> float:
    """The control of a K3 check: the same comparison with the bias zeroed on the
    kernel side, which must fail the tolerance. Returns its error / tolerance."""
    with torch.no_grad():
        unbiased = window_attention(q, k, v, torch.zeros_like(bias), ids_t)
    miss = ((unbiased.float() - want).abs() / (atol + rtol * want.abs())).max().item()
    if miss <= 1.0:
        raise RuntimeError(f"window attention {name}: the tolerance cannot see the bias "
                           f"(zeroed, error {miss:.3f} of the tolerance)")
    return miss


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
        if N > 1:
            miss = k3_bias_control(name, q, k, v, bias, ids_t, want, rtol, atol)
            control = f"; bias zeroed: {miss:.1f}x the tolerance"
        log(f"[kernels] window_attention {name} {(B_, H, N, 32)}: max_abs_err {err:.3e} "
            f"(rtol {rtol}, atol {atol:.3e}){control}")
        report[name] = {"err": err, "inputs": (q, k, v, bias, ids_t)}
        del got, want
    timed = {}
    clip = {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for s, (_, _, blocks) in stages.items():
        for mask in ("masked", "unmasked"):
            name = f"stage {s} {mask} bf16"
            t = time_k3(*report[name]["inputs"], plain=s in (1, 3) and mask == "masked")
            for key in clip:
                clip[key] += blocks // 2 * t[key]
            log_k3_time("kernels", name, report[name]["inputs"][0].shape, t)
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


def k3_ref_windows(q, k, v, bias, ids, chunk: int = 256):
    """window_attention_ref in f32 over slices of `chunk` windows (one clip,
    so B_ == nW and the region ids slice with the windows), so the scores of
    a 64-frame stage 1 are never held at once."""
    if ids is not None and ids.shape[0] != q.shape[0]:
        return window_attention_ref(q.float(), k.float(), v.float(), bias, ids)
    return torch.cat([window_attention_ref(
        q[i:i + chunk].float(), k[i:i + chunk].float(), v[i:i + chunk].float(), bias,
        None if ids is None else ids[i:i + chunk]) for i in range(0, q.shape[0], chunk)])


def checked_kernels(run) -> tuple:
    """run() with every K3 and K1 call held against its plain version in f32
    on the same inputs: K3 at two bf16 ulps of scale, K1 at the kernel phase's
    tolerance. Returns the per-call error / tolerance ratios (K3, K1)."""
    k3_ratios, k1_ratios = [], []
    launch = msda_mod._launch

    def checked_k3(q, k, v, bias, ids):
        out = window_attention(q, k, v, bias, ids)
        want = k3_ref_windows(q, k, v, bias, ids)
        k3_ratios.append((out.float() - want).abs().max().item()
                         / (2 * 2.0 ** -7 * want.abs().max().item()))
        return out

    def checked_k1(value, spatial_shapes, loc, attn, *args, **kwargs):
        out = launch(value, spatial_shapes, loc, attn, *args, **kwargs)
        want = ms_deform_attn_torch(value.float(), spatial_shapes, loc, attn.float())
        tol = fwd_tol(value.dtype)
        k1_ratios.append(miss_ratio(out, want, tol, tol))
        return out

    try:
        video_swin.window_attention = checked_k3
        msda_mod._launch = checked_k1
        run()
    finally:
        video_swin.window_attention = window_attention
        msda_mod._launch = launch
    return k3_ratios, k1_ratios


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
    # which the kernel phase's trained-size bias and its control cover), and the clip's 6
    # K1 calls at the kernel phase's tolerance
    ratios, k1_ratios = checked_kernels(lambda: engine.infer_video(videos[0], texts[0]))
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


def step_outputs(model, batch, crit_cfg, rng, valid: bool = False):
    """One training forward and the criterion's total loss on a device batch
    (the trainer's step without its optimizer and host reads)."""
    out = model(batch["pixels"], batch["pad_mask"], batch["text_ids"], batch["text_mask"],
                sample_sizes=batch["sample_sizes"],
                valid_indices=batch["valid_indices"] if valid else None, training=True, rng=rng)
    return total_loss(compute_criterion(out, {k: batch[k] for k in TARGET_KEYS}, crit_cfg),
                      crit_cfg)


def step_split(model, batch, crit_cfg, optimizer, valid: bool = False) -> tuple:
    """Medians over 3 steps of forward + criterion, backward and optimizer,
    each between CUDA events."""
    rng = torch.Generator(device="cuda")
    split = []
    for i in range(3):
        rng.manual_seed(i)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = step_outputs(model, batch, crit_cfg, rng, valid)
        ev[1].record()
        loss.backward()
        ev[2].record()
        optimizer.apply_gradients()
        ev[3].record()
        ev[3].synchronize()
        split.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
    return tuple(statistics.median(c) for c in zip(*split))


def checked_step(model, batch, crit_cfg, valid: bool = False) -> tuple:
    """One forward and backward with each K1 call held against the plain
    forward (checked_kernels) and each K2 call against the plain backward in
    f32 on the same inputs at the kernel phase's tolerances; the gradients
    are dropped after. Returns the per-call error / tolerance ratios (K1, K2)."""
    k2_ratios = []
    launch_bwd = msda_mod._launch_bwd

    def checked_k2(value, spatial_shapes, loc, attn, grad_out, *args, **kwargs):
        got = launch_bwd(value, spatial_shapes, loc, attn, grad_out, *args, **kwargs)
        want = ms_deform_attn_torch_bwd(value.float(), spatial_shapes, loc, attn.float(),
                                        grad_out.float())
        k2_ratios.append(max(miss_ratio(x, w, *bwd_tols(x, w)) for x, w in zip(got, want)))
        return got

    rng = torch.Generator(device="cuda").manual_seed(3)
    try:
        msda_mod._launch_bwd = checked_k2
        _, k1_ratios = checked_kernels(
            lambda: step_outputs(model, batch, crit_cfg, rng, valid).backward())
    finally:
        msda_mod._launch_bwd = launch_bwd
    model.zero_grad(set_to_none=True)
    return k1_ratios, k2_ratios


def check_history(tag: str, hist, steps: int) -> None:
    """Raises unless `steps` steps ran, every loss term finite and the
    gradient norm finite and positive."""
    if len(hist) != steps:
        raise RuntimeError(f"[{tag}] {len(hist)} steps ran, expected {steps}")
    for i, h in enumerate(hist):
        bad = [k for k, v in h.items() if not np.isfinite(v)]
        if bad or not h["grad_norm"] > 0:
            raise RuntimeError(f"[{tag}] step {i}: non-finite {bad} or grad_norm "
                               f"{h['grad_norm']}")


def check_moved(tag: str, before, after) -> dict:
    """Raises unless the backbone and the main parameters moved and the
    frozen text encoder stayed bit-identical (`before` may be on the CPU)."""
    def changed(prefix=None):
        return any(not torch.equal(after[k].to(v.device), v) for k, v in before.items()
                   if (k.startswith(prefix) if prefix else
                       not k.startswith(("backbone.", "text_encoder."))))

    moved = {"backbone": changed("backbone."), "text": changed("text_encoder."),
             "main": changed()}
    if not (moved["backbone"] and moved["main"]) or moved["text"]:
        raise RuntimeError(f"[{tag}] parameters moved: {moved}; expected backbone and main, "
                           "not the frozen text encoder")
    return moved


def log_checked_step(tag: str, k1_ratios, k2_ratios) -> None:
    """Raises unless one step made 6 K1 and 6 K2 calls, each within its
    tolerance."""
    if (len(k1_ratios), len(k2_ratios)) != (MSDA_PER_CLIP, MSDA_PER_CLIP) \
            or max(k1_ratios + k2_ratios) > 1.0:
        raise RuntimeError(f"[{tag}] one step's kernel calls on the model's inputs, error / "
                           f"tolerance: K1 {k1_ratios}, K2 {k2_ratios}")
    log(f"[{tag}] one step on the model's inputs, error / tolerance: K1 "
        f"{', '.join(f'{r:.3f}' for r in k1_ratios)}; K2 "
        f"{', '.join(f'{r:.3f}' for r in k2_ratios)} (worst of d_value, d_loc, d_attn)")


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
    check_history("train", hist, TRAIN_STEPS)
    after = model.state_dict()
    moved = check_moved("train", before, after)

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

    # one more step split by CUDA events, then one step's 6 K1 and 6 K2 calls checked
    batch = device_batch(next(iter(batches(1))), torch.device("cuda"))
    fwd, bwd, opt = step_split(model, batch, trainer.crit_cfg, state.optimizer)
    log_checked_step("train", *checked_step(model, batch, trainer.crit_cfg))
    log(f"[train] {smi}: step {step_ms:.2f} ms (median of steps 2-{TRAIN_STEPS}, host clock, "
        f"loss read every step) = {1e3 / step_ms:.3f} samples/s; CUDA events: forward + "
        f"criterion {fwd:.2f} ms, backward {bwd:.2f} ms, optimizer {opt:.2f} ms; peak "
        f"memory {peak:.2f} GiB")
    return dict(bwd_launches=counts["bwd_launches"], fwd_launches=counts["launches"],
                step_ms=step_ms)


# ---------------------------------------------------------------- training CLIs
A2D_TRAIN_SAMPLES, A2D_VAL_SAMPLES = 8, 4  # 4 steps of batch 2; the per-epoch evaluator
PRETRAIN_SAMPLES, PRETRAIN_VAL_SAMPLES = 16, 4  # 2 steps of batch 8


class SyntheticRefCOCOVal:
    """A RefCOCO-style val split of single synthetic 360 x 640 frames: `items`
    and `imgs` as RefCOCOClipDataset holds them (the referred square's mask as
    an RLE annotation, its box), samples with the image id and original size
    as its __getitem__ gives them."""

    def __init__(self, num_samples: int, frame_size, seed: int):
        from neurips2023_soc_torch.evaluation.rle import encode

        self.ds = SyntheticRVOSDataset(num_samples=num_samples, num_frames=1,
                                       frame_size=frame_size, seed=seed)
        h, w = frame_size
        self.imgs = {i: {"height": h, "width": w} for i in range(num_samples)}
        self.items = []
        for i in range(num_samples):
            s = self.ds[i]
            x0, y0, x1, y1 = (float(v) for v in s["boxes"][0, 0])
            self.items.append((i, [{"segmentation": encode(s["masks"][0, 0]),
                                    "bbox": [x0, y0, x1 - x0, y1 - y0], "iscrowd": 0,
                                    "area": float(s["masks"][0, 0].sum())}]))

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, idx: int) -> dict:
        return dict(self.ds[idx], image_id=idx, orig_size=self.ds.frame_size)


def msda_counts() -> dict:
    return {k: getattr(ms_deform_attn, k) for k in
            ("launches", "bwd_launches", "plain_calls", "plain_bwd_calls")}


def expect_counts(tag: str, steps: int, forwards: int) -> dict:
    """Raises unless the run since reset_counters made 6 K1 and 6 K2 launches
    per training step, 6 K1 per evaluation forward, no plain MSDA and no K3
    (training runs the plain window attention: K3 has no backward)."""
    got = dict(msda_counts(), k3=window_attention.launches)
    want = {"launches": MSDA_PER_CLIP * (steps + forwards),
            "bwd_launches": MSDA_PER_CLIP * steps, "plain_calls": 0, "plain_bwd_calls": 0,
            "k3": 0}
    if got != want:
        raise RuntimeError(f"[{tag}] kernel counts {got} over {steps} steps and {forwards} "
                           f"evaluation forwards; expected {want}")
    return got


def check_ranged(tag: str, metrics: dict, keys) -> dict:
    """Raises unless there are such metrics and each is finite and in [0, 1]."""
    ranged = {k: v for k, v in metrics.items() if k in keys}
    bad = {k: v for k, v in ranged.items() if not (np.isfinite(v) and 0.0 <= v <= 1.0)}
    if len(ranged) < 6 or bad:
        raise RuntimeError(f"[{tag}] metrics {metrics}")
    return ranged


def read_log(out_dir: str) -> list:
    return [json.loads(line) for line in (Path(out_dir) / "log.txt").read_text().splitlines()]


def check_best(tag: str, trainer, key: str, out_dir: str) -> None:
    """Best by `key`: the trainer's best value is the largest logged one (0
    when none beats the initial 0, as the reference's strict >), and best.json
    exists exactly when one did."""
    values = [rec[f"eval_{key}"] for rec in read_log(out_dir)]
    best_json = (Path(out_dir) / "checkpoints" / "best.json").exists()
    if trainer.best_map != max([0.0] + values) or best_json != (max(values) > 0):
        raise RuntimeError(f"[{tag}] best by {key}: {trainer.best_map} from {values}, "
                           f"best.json {best_json}")


def log_training_numbers(tag: str, smi: str, trainer, batch_size: int, peak: float,
                         valid: bool, eval_samples: int) -> dict:
    """Step ms (median of the first epoch's steps after the first, host clock)
    and samples/s; one step split by CUDA events; one step's K1 and K2 calls
    held against the plain versions; the evaluator's ms per sample."""
    hist = trainer.history
    step_ms = statistics.median(h["step_time_s"] for h in hist[1:]) * 1e3
    batch = device_batch(next(iter(trainer.train_batches(0))), torch.device("cuda"))
    model, crit = trainer.model, trainer.crit_cfg
    fwd, bwd, opt = step_split(model, batch, crit, trainer._state.optimizer, valid)
    log_checked_step(tag, *checked_step(model, batch, crit, valid))
    t0 = time.perf_counter()
    trainer.evaluate_fn(model, trainer.epoch + 1)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) / eval_samples * 1e3
    steps = f"steps 2-{len(hist)}" if len(hist) > 2 else "step 2"
    log(f"[{tag}] {smi}: step {step_ms:.2f} ms (median of {steps}, host clock, "
        f"loss read every step) = {batch_size * 1e3 / step_ms:.3f} samples/s; CUDA events: "
        f"forward + criterion {fwd:.2f} ms, backward {bwd:.2f} ms, optimizer {opt:.2f} ms; "
        f"peak memory {peak:.2f} GiB; evaluator {eval_ms:.2f} ms per sample")
    return dict(step_ms=step_ms, eval_ms=eval_ms)


def train_a2d_path(smi: str, out_dir: str) -> dict:
    """cli/main.run with configs/a2d_sentences.yaml (Video-Swin-T, roberta-base
    frozen, bf16, batch 2 of 8-frame 320 x 576 windows, 4 loader threads) on
    synthetic centre-frame-annotated clips: `train` for one epoch of 4 steps
    with the per-epoch A2D evaluator over 4 synthetic val clips,
    `resume_train` from its checkpoint for a second epoch, then `test` on a
    reference .pth.tar of the epoch-2 weights, whose metrics must equal the
    epoch's logged ones exactly."""
    from neurips2023_soc_torch.cli import main as cli_main
    from neurips2023_soc_torch.training.checkpoint import save_reference_checkpoint

    cfg = load_config(ROOT / "configs" / "a2d_sentences.yaml",
                      overrides={"output_dir": out_dir, "epochs": 1})
    h, w, T, bs = cfg.train_short_size, cfg.train_max_size, cfg.window_size, cfg.batch_size
    if (cfg.backbone, h, w, T, bs, cfg.num_workers, cfg.compute_dtype,
            cfg.freeze_text_encoder) != ("video-swin-t", 320, 576, 8, 2, 4, "bfloat16", True):
        raise RuntimeError(f"[train-a2d] configs/a2d_sentences.yaml changed: {cfg}")
    train = SyntheticRVOSDataset(num_samples=A2D_TRAIN_SAMPLES, num_frames=T, frame_size=(h, w),
                                 seed=0, center_frame_only=True)
    val = SyntheticRVOSDataset(num_samples=A2D_VAL_SAMPLES, num_frames=T, frame_size=(h, w),
                               seed=1, center_frame_only=True)
    init = build_model(cfg, device="cpu", seed=int(cfg.seed)).state_dict()
    steps = A2D_TRAIN_SAMPLES // bs
    forwards = -(-A2D_VAL_SAMPLES // int(cfg.eval_batch_size))

    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first, _ = cli_main.run(cfg, "train", train_dataset=train, val_dataset=val)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = expect_counts("train-a2d", steps, forwards)
    runs = [counts]
    check_history("train-a2d", first.history, steps)
    epoch1 = {k: v.detach().clone() for k, v in first.model.state_dict().items()}
    moved = check_moved("train-a2d", init, epoch1)
    del init
    log(f"[train-a2d] train: {steps} steps of {bs} x {T} x {h} x {w} (valid_indices "
        f"{next(iter(first.train_batches(0)))['valid_indices'].tolist()}) and the evaluator "
        f"over {A2D_VAL_SAMPLES} clips in {wall:.2f} s; losses "
        f"{[round(x['loss'], 4) for x in first.history]}; counts {counts}; moved {moved}")
    del first

    reset_counters()
    resumed, _ = cli_main.run(cfg.replace(epochs=2), "resume_train", train_dataset=train,
                              val_dataset=val)
    counts = expect_counts("train-a2d resume", steps, forwards)
    runs.append(counts)
    check_history("train-a2d resume", resumed.history, steps)
    check_moved("train-a2d resume", epoch1, resumed.model.state_dict())
    del epoch1
    logged = read_log(out_dir)
    if [rec["epoch"] for rec in logged] != [0, 1] or resumed.epoch != 1:
        raise RuntimeError(f"[train-a2d] resume: epochs {[r['epoch'] for r in logged]}")
    evals = {k: v for k, v in logged[-1].items() if k.startswith("eval_")}
    check_ranged("train-a2d", evals, [k for k in evals if k[5:].startswith(("mAP", "P@"))])
    check_best("train-a2d", resumed, "mAP 0.5:0.95", out_dir)

    pth = str(Path(out_dir) / "epoch_1.pth.tar")
    save_reference_checkpoint(resumed.model, pth, epoch=1, total_epochs=2,
                              best_map=resumed.best_map)
    reset_counters()
    _, metrics = cli_main.run(cfg.replace(epochs=2, checkpoint_path=pth), "test",
                              train_dataset=train, val_dataset=val)
    test_counts = expect_counts("train-a2d test", 0, forwards)
    runs.append(test_counts)
    if {f"eval_{k}": v for k, v in metrics.items()} != evals:
        raise RuntimeError(f"[train-a2d] test on the .pth.tar: {metrics}; epoch 2 logged {evals}")
    log(f"[train-a2d] resume_train: epoch 2 of {steps} steps, counts {counts}; test on the "
        f"reference .pth.tar of the epoch-2 weights (strict): metrics equal the logged epoch's, "
        f"counts {test_counts}")
    log("[train-a2d] epoch 2 metrics (random init): " + ", ".join(
        f"{k[5:]} {v:.4f}" for k, v in evals.items()))
    out = log_training_numbers("train-a2d", smi, resumed, bs, peak, True, A2D_VAL_SAMPLES)
    return dict(out, k1=sum(c["launches"] for c in runs), k2=sum(c["bwd_launches"] for c in runs))


def pretrain_path(smi: str, out_dir: str) -> dict:
    """cli/main_pretrain.run with configs/refcoco_pretrain.yaml (Video-Swin-T,
    bf16, batch 8 of single 360 x 640 frames) over 16 synthetic frames (2
    steps) with build_pretrain_evaluator over one synthetic val split of 4."""
    from neurips2023_soc_torch.cli import main_pretrain

    cfg = load_config(ROOT / "configs" / "refcoco_pretrain.yaml",
                      overrides={"output_dir": out_dir, "epochs": 1})
    h, w, bs = cfg.train_short_size, cfg.train_max_size, cfg.batch_size
    if (cfg.backbone, h, w, bs, cfg.compute_dtype, cfg.dataset_name) != (
            "video-swin-t", HEIGHT, WIDTH, 8, "bfloat16", "coco_refer"):
        raise RuntimeError(f"[pretrain] configs/refcoco_pretrain.yaml changed: {cfg}")
    train = SyntheticRVOSDataset(num_samples=PRETRAIN_SAMPLES, num_frames=1, frame_size=(h, w),
                                 seed=2)
    val_sets = [("refcoco", SyntheticRefCOCOVal(PRETRAIN_VAL_SAMPLES, (h, w), seed=3))]
    init = build_model(cfg, device="cpu", seed=int(cfg.seed)).state_dict()
    steps = PRETRAIN_SAMPLES // bs
    forwards = -(-PRETRAIN_VAL_SAMPLES // int(cfg.eval_batch_size))

    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, _ = main_pretrain.run(cfg, "train", train_dataset=train, val_sets=val_sets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = expect_counts("pretrain", steps, forwards)
    check_history("pretrain", trainer.history, steps)
    moved = check_moved("pretrain", init, trainer.model.state_dict())
    del init
    pixels = next(iter(trainer.train_batches(0)))["pixels"]
    if pixels.shape[:2] != (1, bs):
        raise RuntimeError(f"[pretrain] batch pixels {pixels.shape}, expected T = 1")
    evals = {k: v for k, v in read_log(out_dir)[-1].items() if k.startswith("eval_")}
    check_ranged("pretrain", evals, [k for k in evals if k == "eval_mean_mask_mAP" or k.startswith(
        ("eval_refcoco_mAP", "eval_refcoco_P@", "eval_refcoco_bbox P@", "eval_refcoco_recall@"))])
    check_best("pretrain", trainer, "mean_mask_mAP", out_dir)
    log(f"[pretrain] {steps} steps of {bs} x 1 x {h} x {w} and the evaluator over "
        f"{PRETRAIN_VAL_SAMPLES} frames in {wall:.2f} s; losses "
        f"{[round(x['loss'], 4) for x in trainer.history]}; counts {counts}; moved {moved}")
    log("[pretrain] metrics (random init): " + ", ".join(
        f"{k[5:]} {v:.4f}" for k, v in evals.items()))
    out = log_training_numbers("pretrain", smi, trainer, bs, peak, False, PRETRAIN_VAL_SAMPLES)
    return dict(out, k1=counts["launches"], k2=counts["bwd_launches"])


# ---------------------------------------------------------------- DAVIS and A2D eval
DAVIS_T, DAVIS_H, DAVIS_W = 80, 480, 854  # DAVIS-17's frame size, about its mean length
DAVIS_TEXTS = (  # object-major: exp id = obj * 4 + anno
    "the red ball", "a red ball rolling to the right", "red round object",
    "the red ball crossing the field",
    "the blue box", "a blue box sliding down", "blue square object",
    "the blue box moving down the frame")
K3_PER_PASS_T = 12  # Video-Swin-T: 2 + 2 + 6 + 2 blocks
SWIN_T_STAGES = {1: (3, 2), 2: (6, 2), 3: (12, 6), 4: (24, 2)}  # heads, blocks
A2D_SAMPLES = 8


class SyntheticDavisVideo:
    """data/davis.py:ReferDAVISDataset's interface over one synthetic video:
    80 uint8 frames of 480 x 854 with two moving objects (a red disk, a blue
    box) on a textured background, 4 expressions per object. Frames are
    resized on the card to the config's eval size as the test transforms
    would; no JPEG is decoded (PIL is not among the card machine's packages).
    `gt` holds the (T, H, W) index masks at the original size."""

    def __init__(self, short: int, longest: int, seed: int = 0):
        rng = np.random.RandomState(seed)
        T, H, W = DAVIS_T, DAVIS_H, DAVIS_W
        yy, xx = np.mgrid[:H, :W].astype(np.float32)
        base = (60 + 40 * np.sin(xx / 37.0)[..., None] * np.cos(yy / 23.0)[..., None]
                + rng.randint(0, 40, (H, W, 3))).clip(0, 255).astype(np.uint8)
        frames = np.repeat(base[None], T, 0)
        self.gt = np.zeros((T, H, W), np.uint8)
        for t in range(T):
            disk = (xx - (120 + 6 * t)) ** 2 + (yy - 260 - 60 * np.sin(t / 9)) ** 2 < 70 ** 2
            box = (np.abs(xx - 600 + 2 * t) < 80) & (np.abs(yy - (90 + 3 * t)) < 55)
            frames[t][disk] = (220, 30, 30)
            frames[t][box] = (30, 40, 220)
            self.gt[t][disk] = 1
            self.gt[t][box] = 2  # the box in front
        from neurips2023_soc_torch.data.transforms import size_with_aspect_ratio

        oh, ow = size_with_aspect_ratio(H, W, short, longest)
        x = torch.from_numpy(frames).cuda().permute(0, 3, 1, 2).float()
        x = F.interpolate(x, size=(oh, ow), mode="bilinear", antialias=True,
                          align_corners=False)
        self.frames = x.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
        names = [f"{t:05d}" for t in range(T)]
        self.samples_list = [("synthetic", names, {"exp": e, "exp_id": str(i)})
                             for i, e in enumerate(DAVIS_TEXTS)]

    def __len__(self):
        return len(self.samples_list)

    def get_text(self, idx: int) -> str:
        return " ".join(self.samples_list[idx][2]["exp"].lower().split())

    def __getitem__(self, idx: int) -> dict:
        vid, names, exp = self.samples_list[idx]
        return {"frames": self.frames, "text": self.get_text(idx), "video_metadata": {
            "video_id": vid, "frame_indices": list(names),
            "resized_frame_size": tuple(self.frames.shape[1:3]),
            "original_frame_size": (DAVIS_H, DAVIS_W), "exp_id": exp["exp_id"]}}


def swin_t_k3_times(T: int) -> dict:
    """K3 at Video-Swin-T's four stage shapes of a T x 360 x 640 chunk (heads 3, 6,
    12, 24), masked and unmasked, with a trained table's bias spread: each held
    against window_attention_ref in f32 at the kernel phase's bf16 tolerance, with
    the zeroed-bias control; then K3, SDPA and the bound timed, and summed over one
    backbone pass (12 blocks, half of them shifted)."""
    win = (8, 7, 7)
    per_pass = {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    rows = {}
    for s, (heads, blocks) in SWIN_T_STAGES.items():
        grid = (T, -(-HEIGHT // 2 ** (s + 1)), -(-WIDTH // 2 ** (s + 1)))
        nW, N, ids = window_geometry(*grid, win, True)
        for mask in ("masked", "unmasked"):
            name = f"Swin-T stage {s} {mask} bf16"
            inputs = wattn_inputs(nW, heads, N, ids if mask == "masked" else None,
                                  torch.bfloat16, seed=40 + s)
            with torch.no_grad():
                got = window_attention(*inputs)
                want = k3_ref_windows(*inputs)
            atol = 2 * 2.0 ** -7 * want.abs().max().item()
            err = (got.float() - want).abs().max().item()
            if err > atol:
                raise RuntimeError(f"[davis] window attention kernel vs plain, {name}: "
                                   f"max_abs_err {err:.3e} above atol {atol:.3e}")
            miss = k3_bias_control(name, *inputs, want, 0.0, atol)
            log(f"[davis] window_attention {name} {tuple(inputs[0].shape)}: max_abs_err "
                f"{err:.3e} (rtol 0.0, atol {atol:.3e}); bias zeroed: {miss:.1f}x the "
                f"tolerance")
            del got, want
            t = time_k3(*inputs)
            log_k3_time("davis", name, inputs[0].shape, t)
            rows[name] = t
            for key in per_pass:
                per_pass[key] += blocks // 2 * t[key]
            del inputs
    log(f"[davis] window_attention per Video-Swin-T backbone pass of a {T} x {HEIGHT} x {WIDTH} "
        f"chunk (sum of launches x time over its {K3_PER_PASS_T} blocks): kernel "
        f"{per_pass['ms']:.4f} ms, SDPA {per_pass['library_ms']:.4f} ms, bound "
        f"{per_pass['bound_ms']:.4f} ms")
    return rows


def davis_path(smi: str) -> dict:
    """Ref-DAVIS-17 inference as cli/infer_davis.py runs it, at configs/davis.yaml's
    widths with swin_attn_impl: pallas: one synthetic 80 x 480 x 854 video of 2
    objects (8 expressions) through davis_videos / item_fn / merge_annotators
    over run_videos_pipelined, probabilities per chunk (64 + 16 frames); J&F of
    every annotation variant against the synthetic ground truth; each K3 and K1
    call of the first chunk held against its plain version; K3 checked and timed
    at Video-Swin-T's stage shapes."""
    from concurrent.futures import ThreadPoolExecutor
    from functools import partial

    from neurips2023_soc_torch.cli import infer_davis
    from neurips2023_soc_torch.cli.eval_davis import _split_objects
    from neurips2023_soc_torch.cli.infer_refytb import build_engine
    from neurips2023_soc_torch.evaluation.davis import evaluate_sequences
    from neurips2023_soc_torch.inference import DEFAULT_TIME_BUCKETS, eval_size_buckets

    cfg = load_config(ROOT / "configs" / "davis.yaml", overrides={"swin_attn_impl": "pallas"})
    widths = (cfg.backbone, cfg.DeformTransformer["d_model"], cfg.text_encoder_type,
              cfg.compute_dtype)
    if widths != ("video-swin-t", 256, "roberta-base", "bfloat16"):
        raise RuntimeError(f"configs/davis.yaml changed: {widths}")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    engine = build_engine(cfg, model, torch.device("cuda"),
                          eval_size_buckets(cfg.eval_short_size, cfg.eval_max_size))
    ds = SyntheticDavisVideo(cfg.eval_short_size, cfg.eval_max_size)
    videos = infer_davis.davis_videos(ds)
    item_fn = partial(infer_davis.item_fn, ds)
    chunk = max(cfg.get("time_buckets") or DEFAULT_TIME_BUCKETS)
    chunks = -(-DAVIS_T // chunk)
    log(f"[davis] built SOC video-swin-t bf16 (swin_attn_impl pallas) and the synthetic "
        f"video {ds.frames.shape} (from {DAVIS_T} x {DAVIS_H} x {DAVIS_W}) in "
        f"{time.perf_counter() - t0:.1f} s; {len(videos)} video, {len(ds)} expressions, "
        f"{chunks} chunks of up to {chunk} frames")
    t0 = time.perf_counter()
    engine.infer_video_multi(**{**item_fn(dict(videos[0])), "texts": [ds.get_text(0)]})
    torch.cuda.synchronize()
    log(f"[davis] warm-up (one expression) in {time.perf_counter() - t0:.1f} s")

    merge_s = []

    def merge(w, probs):  # the CLI's merge, timed: it runs on the host after the fetch
        t = time.perf_counter()
        out = infer_davis.merge_annotators(w, probs)
        merge_s.append(time.perf_counter() - t)
        return out

    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    merged = run_videos_pipelined(engine, videos, item_fn, merge)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    got = dict(k3=window_attention.launches, k3_plain=window_attention.plain_calls,
               xla_attn=window_attention_torch.calls, k1=ms_deform_attn.launches,
               k1_plain=ms_deform_attn.plain_calls)
    want = dict(k3=K3_PER_PASS_T * chunks, k3_plain=0, xla_attn=0,
                k1=MSDA_PER_CLIP * chunks * len(ds), k1_plain=0)
    if got != want:
        raise RuntimeError(f"[davis] kernel counts {got}, expected {want}")
    for a, m in enumerate(merged):
        if m.shape != (DAVIS_T, DAVIS_H, DAVIS_W) or m.dtype != np.uint8 \
                or not set(np.unique(m).tolist()) <= {0, 1, 2}:
            raise RuntimeError(f"[davis] annotator {a}: index masks {m.shape} {m.dtype} "
                               f"values {np.unique(m)[:8]}")
    log(f"[davis] {smi}: {len(ds)} expressions of one {DAVIS_T}-frame video in {wall:.3f} s "
        f"= {DAVIS_T / wall:.2f} engine frames/s ({DAVIS_T * len(ds) / wall:.2f} "
        f"expression-frames/s), of which the host merge of the 4 annotators {merge_s[0]:.3f} "
        f"s; peak memory {peak:.2f} GiB; counts {got}")

    gt = _split_objects(ds.gt, [1, 2])

    def jf(m):
        return evaluate_sequences({"synthetic": (gt, _split_objects(m))})["global"]

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(merged)) as ex:
        scores = list(ex.map(jf, merged))
    for a, sc in enumerate(scores):
        bad = {k: v for k, v in sc.items() if not np.isfinite(v)
               or not (-1.0 <= v <= 1.0 if "Decay" in k else 0.0 <= v <= 1.0)}
        if bad:
            raise RuntimeError(f"[davis] annotator {a}: J&F out of range {bad}")
    log(f"[davis] J&F against the synthetic ground truth ({time.perf_counter() - t0:.1f} s, "
        f"random weights): " + "; ".join(
            f"anno_{a} J&F {sc['J&F-Mean']:.4f} J {sc['J-Mean']:.4f} F {sc['F-Mean']:.4f}"
            for a, sc in enumerate(scores)))

    first = item_fn(dict(videos[0]))
    first["frames"] = first["frames"][:chunk]
    k3_ratios, k1_ratios = checked_kernels(lambda: engine.infer_video_multi(**first))
    if len(k3_ratios) != K3_PER_PASS_T or max(k3_ratios) > 1.0:
        raise RuntimeError(f"[davis] K3 on the model's inputs: {len(k3_ratios)} calls, error / "
                           f"tolerance {k3_ratios}")
    if len(k1_ratios) != MSDA_PER_CLIP * len(ds) or max(k1_ratios) > 1.0:
        raise RuntimeError(f"[davis] K1 on the model's inputs: {len(k1_ratios)} calls, error / "
                           f"tolerance {k1_ratios}")
    log(f"[davis] first chunk ({chunk} frames): K3 on the model's {len(k3_ratios)} inputs, error "
        f"up to {max(k3_ratios):.3f} of the two-ulp tolerance; K1 on its {len(k1_ratios)} "
        f"inputs, error up to {max(k1_ratios):.3f} of the tolerance")
    swin_t_k3_times(chunk)
    return dict(wall=wall, fps=DAVIS_T / wall, peak=peak, k3=got["k3"], k1=got["k1"])


def a2d_eval_path(smi: str) -> dict:
    """The A2D-Sentences evaluator at configs/a2d_sentences.yaml's widths:
    build_a2d_evaluator over 8 centre-frame-annotated synthetic samples of 8 x
    320 x 576 at the config's eval batch size; every mAP and P@ metric in [0, 1],
    6 K1 launches per forward, one forward's 6 K1 calls held against the plain
    version, and a2d_device_step on the card against the same step on the CPU on
    one forward's outputs."""
    from neurips2023_soc_torch.data import collate_batch
    from neurips2023_soc_torch.evaluators import build_a2d_evaluator, evaluating, forward_batch
    from neurips2023_soc_torch.inference import eval_size_buckets
    from neurips2023_soc_torch.models.postprocessing import a2d_device_step

    cfg = load_config(ROOT / "configs" / "a2d_sentences.yaml")
    h, w = cfg.eval_short_size, cfg.eval_max_size
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    tok = build_tokenizer(cfg.text_encoder_type, cfg.text_bucket)
    ds = SyntheticRVOSDataset(num_samples=A2D_SAMPLES, num_frames=cfg.window_size,
                              frame_size=(h, w), seed=0, center_frame_only=True)
    collate_kwargs = dict(size_buckets=eval_size_buckets(h, w),
                          time_buckets=(cfg.window_size,))
    bs = int(cfg.eval_batch_size)
    evaluate = build_a2d_evaluator(ds, tok, eval_batch_size=bs,
                                   calculate_pr=cfg.calculate_precision_and_iou_metrics,
                                   collate_kwargs=collate_kwargs)
    batch = collate_batch([ds[i] for i in range(bs)], tok, **collate_kwargs)
    with evaluating(model):
        forward_batch(model, batch)  # warm-up
    torch.cuda.synchronize()
    log(f"[a2d-eval] built SOC {cfg.backbone} bf16 and warmed up in "
        f"{time.perf_counter() - t0:.1f} s; {A2D_SAMPLES} samples of {cfg.window_size} x {h} "
        f"x {w}, eval batch {bs}")

    reset_counters()
    t0 = time.perf_counter()
    metrics = evaluate(model, 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    forwards = -(-A2D_SAMPLES // bs)
    got = dict(k1=ms_deform_attn.launches, k1_plain=ms_deform_attn.plain_calls,
               k3=window_attention.launches, xla_attn=window_attention_torch.calls)
    want = dict(k1=MSDA_PER_CLIP * forwards, k1_plain=0, k3=0,
                xla_attn=K3_PER_PASS_T * forwards)
    if got != want:
        raise RuntimeError(f"[a2d-eval] kernel counts {got}, expected {want}")
    ranged = {k: v for k, v in metrics.items() if k.startswith(("mAP", "P@"))}
    bad = {k: v for k, v in ranged.items() if not (np.isfinite(v) and 0.0 <= v <= 1.0)}
    if len(ranged) < 6 or bad:
        raise RuntimeError(f"[a2d-eval] metrics {metrics}")
    if model.training:
        raise RuntimeError("[a2d-eval] the evaluator left the model in training mode")

    def one_forward():
        with evaluating(model):
            forward_batch(model, batch)

    k3_ratios, k1_ratios = checked_kernels(one_forward)
    if k3_ratios or len(k1_ratios) != MSDA_PER_CLIP or max(k1_ratios) > 1.0:
        raise RuntimeError(f"[a2d-eval] in-model checks of one forward: K3 {k3_ratios}, "
                           f"K1 error / tolerance {k1_ratios}")
    log(f"[a2d-eval] K1 on the model's {len(k1_ratios)} inputs of one forward: error / "
        f"tolerance " + ", ".join(f"{r:.3f}" for r in k1_ratios)
        + f" (worst {max(k1_ratios):.3f}); no K3 call (swin_attn_impl xla)")

    with evaluating(model):
        fwd_ms = time_ms(lambda: forward_batch(model, batch), iters=10, warmup=2)
        out = forward_batch(model, batch)
        pc, pm = out["pred_cls"][-1], out["pred_masks"][-1]
        pad = batch["pixels"].shape[2:4]
        card = a2d_device_step(pc, pm, *pad)
        host = a2d_device_step(pc.cpu(), pm.cpu(), *pad)
    score_err = (card[0].cpu() - host[0]).abs().max().item()
    agree = (card[1].cpu() == host[1]).float().mean().item()
    if score_err > 1e-6 or agree < 0.9999:
        raise RuntimeError(f"[a2d-eval] a2d_device_step card vs CPU: scores {score_err:.3e}, "
                           f"masks agree on {agree:.6f} of the pixels")
    log(f"[a2d-eval] {smi}: evaluator {wall:.3f} s for {A2D_SAMPLES} samples = "
        f"{wall / A2D_SAMPLES * 1e3:.2f} ms per sample; forward {fwd_ms:.2f} ms (CUDA events, "
        f"batch {bs}); counts {got}; a2d_device_step card vs CPU: scores {score_err:.3e}, "
        f"masks agree on {agree:.6f} of {card[1].numel()} pixels")
    log("[a2d-eval] metrics (random weights): " + ", ".join(
        f"{k} {v:.4f}" for k, v in metrics.items()))
    return dict(wall=wall, fwd_ms=fwd_ms, k1=got["k1"])


def small_reference(attn_impl: str, T: int = 4) -> None:
    """A small float32 SOC on the card against the same weights on the CPU
    (plain versions: window_attention_torch for xla, window_attention_ref
    for pallas) on T frames (T = 1: the pretraining shape, with the temporal
    patch pad and windows clamped to one frame)."""
    kw = dict(backbone_name="video-swin-t", d_model=64, num_queries=5,
              dim_feedforward=128, enc_layers=1, dec_layers=2, voc_enc_layers=1,
              voc_dec_layers=1, text_encoder_type="roberta-tiny", swin_attn_impl=attn_impl)
    cpu = init_weights(SOC(**kw), torch.Generator().manual_seed(1)).eval()
    gpu = init_weights(SOC(**kw), torch.Generator().manual_seed(1)).cuda().eval()
    rng = np.random.RandomState(1)
    px = torch.from_numpy(rng.randn(T, 2, 48, 64, 3).astype(np.float32))
    pad = torch.zeros(T, 2, 48, 64, dtype=torch.bool)
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
        raise RuntimeError(f"small SOC {attn_impl} T={T}: window attention (kernel, ref, torch) "
                           f"calls {seen}, expected {expected}")
    for k in ("pred_masks", "pred_cls", "pred_boxes", "pred_logit"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-3, atol=1e-3,
                                   msg=lambda m: f"small SOC {attn_impl} T={T} cuda vs cpu, {k}: {m}")
    log(f"[small] SOC video-swin-t d_model 64 f32, T = {T}, swin_attn_impl {attn_impl}: card == CPU "
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
    if argv == ["--train-times"]:
        _build.build_all()
        with tempfile.TemporaryDirectory(prefix="soc_train_") as out_dir:
            train_path(smi, out_dir)
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv} (none, --msda-times or --train-times)",
              file=sys.stderr)
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
    with tempfile.TemporaryDirectory(prefix="soc_train_a2d_") as out_dir:
        a2d = train_a2d_path(smi, out_dir)
    with tempfile.TemporaryDirectory(prefix="soc_pretrain_") as out_dir:
        pretrain = pretrain_path(smi, out_dir)
    # the launches of the paths that run each kernel: K1 in inference and in the
    # new training entry points, K2 in every training path
    k1["launches"] += a2d["k1"] + pretrain["k1"]
    k2["launches"] = train["bwd_launches"] + a2d["k2"] + pretrain["k2"]
    small_reference("xla")
    small_reference("pallas")
    small_reference("xla", T=1)
    davis_path(smi)
    a2d_eval_path(smi)

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
