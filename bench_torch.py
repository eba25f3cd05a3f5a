"""Benchmark of the PyTorch port (neurips2023_soc_torch) on one CUDA card: the
counterpart of bench.py (whole-clip Ref-YouTube-VOS referring inference) and
bench_train.py (the training step). Prints one JSON line.

    python3 bench_torch.py

The model is the main path's: Video-Swin-B, d_model 256, 20 queries, FFN 2048,
3 + 3 deformable layers, VOC 3 + 3, roberta-base, bfloat16
(configs/refer_youtube_vos.yaml, the widths of bench.py:163-176), T = 16 frames
of 360 x 640, with the weights of convert.seeded_state_dict(model, 0) and TF32
off. For swin_attn_impl `pallas` (window attention through kernel K3) and
`xla` (the plain version) it measures:

  device  the clip forward on a device-resident input perturbed each call,
          with the trajectory selection inside the forward and one scalar
          fetched per call: synchronous (one clip at a time) and pipelined at
          depth 1 (clip i+1 queued before clip i's scalar is read);
  engine  InferenceEngine: infer_video_multi one video at a time (sync) and
          infer_videos at depth 1 (pipelined) over BENCH_VIDEOS distinct
          videos, from uint8 RGB and from yuv420 input.

Also `multi_expression` (8 expressions on one video through
infer_video_multi; K3 only), `secondary` (Video-Swin-T with K3, device and
engine) and `train` (bench_train.py's step: T = 8, 360 x 640, batch BENCH_B,
frozen RoBERTa, AdamW through training.make_train_step, fresh inputs and the
loss read every step; Video-Swin-T and Video-Swin-B with the plain window
attention, as K3 has no backward). Each number is a median with its min and
max: over BENCH_ITERS (>= 10) clips for sync, over 3 rounds for pipelined,
over BENCH_TRAIN_ITERS (>= 5) steps for training, after warm-up. Each block
carries the launches of K1 (MSDA forward), K2 (MSDA backward) and K3 that
its measurement made.

Knobs: BENCH_FRAMES, BENCH_DTYPE, BENCH_ITERS, BENCH_VIDEOS, BENCH_BACKBONE
(one backbone: skips `secondary` and trains only it), BENCH_SWIN_ATTN (one
window attention), BENCH_B, BENCH_TRAIN_ITERS, BENCH_REMAT (use_remat in
training), BENCH_SKIP_PROXY (no device block), BENCH_SKIP_MULTI, BENCH_SKIP_TRAIN.
Lower counts than the defaults are for a smoke run, not for a reading.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from neurips2023_soc_torch.config import load_config
from neurips2023_soc_torch.convert import seeded_state_dict
from neurips2023_soc_torch.inference import InferenceEngine, rgb_to_yuv420
from neurips2023_soc_torch.losses import CriterionConfig
from neurips2023_soc_torch.models import build_model
from neurips2023_soc_torch.models.text_encoder import build_tokenizer
from neurips2023_soc_torch.ops import ms_deform_attn, window_attention
from neurips2023_soc_torch.training.optim import build_optimizer
from neurips2023_soc_torch.training.train_step import TrainState, make_train_step

ROOT = Path(__file__).resolve().parent
H, W = 360, 640
TEXT = "a person riding a bike on the left"


def launch_counts() -> dict:
    return dict(k1=ms_deform_attn.launches, k2=ms_deform_attn.bwd_launches,
                k3=window_attention.launches)


def reset_counts() -> None:
    ms_deform_attn.launches = ms_deform_attn.bwd_launches = 0
    window_attention.launches = 0


def spread(values) -> dict:
    """Median with min and max."""
    return dict(median=statistics.median(values), min=min(values), max=max(values))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_device(model, T: int, iters: int, H: int = H, W: int = W,
                   text_encoder_type: str = "roberta-base", text_bucket: int = 32) -> dict:
    """Frames/s of the clip forward alone (bench.py:measure_proxy): the input
    stays on the device and is perturbed each call, the chosen query's masks
    are selected inside the forward, and one scalar of them is fetched per
    call. sync: one clip at a time, over `iters` clips; pipelined: clip i+1
    queued before clip i's scalar is read, 3 rounds of `iters` clips."""
    dev = next(model.parameters()).device
    rng = np.random.RandomState(0)
    pixels = torch.from_numpy(rng.randn(T, 1, H, W, 3).astype(np.float32)).to(dev)
    pad = torch.zeros(T, 1, H, W, dtype=torch.bool, device=dev)
    ids, msk = (torch.from_numpy(np.asarray(a)).to(dev)
                for a in build_tokenizer(text_encoder_type, text_bucket)([TEXT]))

    @torch.no_grad()
    def forward(k: float) -> torch.Tensor:
        out = model(pixels + k, pad, ids, msk)
        best = torch.sigmoid(out["pred_cls"][-1].float()).mean(0).amax(-1).argmax(-1)  # (B,)
        masks = out["pred_masks"][-1]  # (T, B, Nq, h, w)
        sel = masks.gather(2, best.view(1, -1, 1, 1, 1).expand(
            T, masks.shape[1], 1, *masks.shape[3:]))
        return sel.float().mean()

    forward(0.0).item()
    forward(0.5).item()  # a second warm call on another input
    sync = []
    for i in range(iters):
        t0 = time.perf_counter()
        forward(float(i + 1)).item()
        sync.append(T / (time.perf_counter() - t0))
    rounds, seq = [], 1000
    for _ in range(3):
        pending = []
        t0 = time.perf_counter()
        for _ in range(iters):
            seq += 1
            pending.append(forward(float(seq)))
            if len(pending) > 1:
                pending.pop(0).item()
        for p in pending:
            p.item()
        rounds.append(T * iters / (time.perf_counter() - t0))
    return dict(sync_fps=spread(sync), pipelined_fps=spread(rounds))


def measure_engine(model, T: int, n_videos: int, iters: int, fmt: str = "uint8",
                   expressions: int = 1, H: int = H, W: int = W,
                   text_encoder_type: str = "roberta-base", text_bucket: int = 32) -> dict:
    """Frames/s through InferenceEngine (bench.py:measure_engine), host work
    included: every video's pixels differ and every mask is fetched. sync:
    infer_video_multi one video at a time over `iters` videos; pipelined:
    infer_videos at depth 1, 3 rounds of `n_videos` videos. `fmt` is the
    input, uint8 RGB or yuv420 planes; with `expressions` > 1 each video runs
    that many texts and frames/s counts frames x expressions."""
    dev = next(model.parameters()).device
    engine = InferenceEngine(model, text_encoder_type=text_encoder_type,
                             text_bucket=text_bucket, time_buckets=(T,),
                             size_buckets=((H, W),), device=dev)
    texts = [f"expression number {k} describing the object" for k in range(expressions)]
    base = np.random.RandomState(42).randint(0, 256, (T, H, W, 3)).astype(np.uint8)
    planes = rgb_to_yuv420(base) if fmt == "yuv420" else None

    def items(seed0: int, n: int):
        for i in range(n):
            first = (planes[0] if planes else base).copy()
            first[:, 0, 0, ...] = (seed0 + i) % 256
            first[:, 1, 0, ...] = ((seed0 + i) // 256) % 256
            frames = (first, planes[1], planes[2]) if planes else first
            yield dict(frames=frames, texts=texts, original_size=(H, W))

    for _ in engine.infer_videos(items(10_000, 2), depth=1):
        pass
    sync = []
    for item in items(20_000, iters):
        t0 = time.perf_counter()
        res = engine.infer_video_multi(**item)
        sync.append(T * expressions / (time.perf_counter() - t0))
        if res[0].shape != (T, H, W):
            raise RuntimeError(f"engine masks {res[0].shape}, expected {(T, H, W)}")
    rounds = []
    for r in range(3):
        t0 = time.perf_counter()
        for res in engine.infer_videos(items(30_000 + r * n_videos, n_videos), depth=1):
            if res[0].dtype != np.uint8:
                raise RuntimeError(f"engine masks of dtype {res[0].dtype}")
        rounds.append(T * expressions * n_videos / (time.perf_counter() - t0))
    return dict(sync_fps=spread(sync), pipelined_fps=spread(rounds))


def train_batch(T: int, B: int, H: int = H, W: int = W, S: int = 16) -> dict:
    """bench_train.py's synthetic batch: one referred instance per clip, its
    box at the centre and its mask a rectangle."""
    rng = np.random.RandomState(0)
    masks = np.zeros((T, B, 1, H, W), np.float32)
    masks[:, :, :, H * 5 // 18:H * 13 // 18, W * 5 // 16:W * 11 // 16] = 1.0
    return {
        "pixels": rng.randn(T, B, H, W, 3).astype(np.float32),
        "pad_mask": np.zeros((T, B, H, W), bool),
        "text_ids": rng.randint(3, 1000, (B, S)).astype(np.int32),
        "text_mask": np.ones((B, S), np.int32),
        "sample_sizes": np.tile(np.array([H, W], np.float32), (B, 1)),
        "masks": masks,
        "boxes": np.tile(np.array([0.5, 0.5, 0.3, 0.3], np.float32), (T, B, 1, 1)),
        "labels": np.zeros((B, 1), np.int32),
        "inst_valid": np.ones((B, 1), bool),
        "is_ref_inst_visible": np.ones((T, B, 1), bool),
        "referred_instance_idx": np.zeros((B,), np.int32),
    }


def measure_train(model, T: int, B: int, iters: int, H: int = H, W: int = W) -> dict:
    """Step ms of training.make_train_step (bench_train.py): AdamW with
    bench.py's learning rates, the text encoder frozen; a fresh input (the
    pixels moved by 1e-3 per step) each step and the loss read after it;
    samples/s from the median step; peak device memory (CUDA only)."""
    dev = next(model.parameters()).device
    model.train()
    state = TrainState(model, build_optimizer(model, lr=1e-4, lr_backbone=1e-5,
                                              text_encoder_lr=5e-6))
    step = make_train_step(model, CriterionConfig())
    batch = {k: torch.from_numpy(v).to(dev) for k, v in train_batch(T, B, H, W).items()}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def one(i: int) -> float:
        b = dict(batch, pixels=batch["pixels"] + (i + 1) * 1e-3)
        _, metrics = step(state, b, i)
        loss = metrics["loss"].item()
        if not np.isfinite(loss):
            raise RuntimeError(f"training step {i}: loss {loss}")
        return loss

    one(1000)
    one(1001)  # a second warm step on another input
    times, losses = [], []
    for i in range(iters):
        _sync(dev)
        t0 = time.perf_counter()
        losses.append(one(i))
        times.append((time.perf_counter() - t0) * 1e3)
    out = dict(step_ms=spread(times), samples_per_s=B * 1e3 / statistics.median(times),
               losses=losses)
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return out


def counted(fn, *args, **kwargs) -> dict:
    """fn's result with the kernel launches it made."""
    reset_counts()
    out = fn(*args, **kwargs)
    out["launches"] = launch_counts()
    return out


class Models:
    """Full-width SOCs on the card with seeded weights, one state dict per
    backbone made once."""

    def __init__(self, dtype: str):
        self.dtype, self._weights = dtype, {}

    def build(self, backbone: str, attn: str, remat: bool = False):
        cfg = load_config(ROOT / "configs" / "refer_youtube_vos.yaml", overrides={
            "backbone": backbone, "compute_dtype": self.dtype, "swin_attn_impl": attn,
            "use_checkpoint": remat})
        model = build_model(cfg, device="cuda", seed=0)
        if backbone not in self._weights:
            self._weights[backbone] = {k: torch.from_numpy(v) for k, v in
                                       seeded_state_dict(model, 0).items()}
        model.load_state_dict(self._weights[backbone], strict=True)
        return model.eval()


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_torch.py measures the CUDA card; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    T = int(os.environ.get("BENCH_FRAMES", 16))
    dtype = os.environ.get("BENCH_DTYPE", "bfloat16")
    iters = int(os.environ.get("BENCH_ITERS", 10))
    n_videos = int(os.environ.get("BENCH_VIDEOS", 8))
    only = os.environ.get("BENCH_BACKBONE")
    attns = [os.environ["BENCH_SWIN_ATTN"]] if os.environ.get("BENCH_SWIN_ATTN") \
        else ["pallas", "xla"]
    skip = {k for k in ("PROXY", "MULTI", "TRAIN") if os.environ.get(f"BENCH_SKIP_{k}") == "1"}
    primary = only or "video-swin-b"
    models = Models(dtype)
    record = dict(
        metric=f"port_ytvos_engine_fps_{primary}_{T}f_{H}x{W}_{dtype}",
        card=card(), device=torch.cuda.get_device_name(0), torch=torch.__version__,
        cuda=torch.version.cuda, frames=T, dtype=dtype, iters=iters, videos=n_videos)

    def inference(backbone: str, attn: str, multi: bool) -> dict:
        model = models.build(backbone, attn)
        r = {}
        if "PROXY" not in skip:
            r["device"] = counted(measure_device, model, T, iters)
        r["engine_u8"] = counted(measure_engine, model, T, n_videos, iters)
        if backbone == primary:
            r["engine_yuv420"] = counted(measure_engine, model, T, n_videos, iters,
                                         fmt="yuv420")
        if multi:
            m8 = counted(measure_engine, model, T, max(3, n_videos // 2), iters,
                         expressions=8)
            m8["speedup_vs_8_single_passes"] = (m8["pipelined_fps"]["median"]
                                                / r["engine_u8"]["pipelined_fps"]["median"])
            r["multi_expression"] = m8
        del model
        torch.cuda.empty_cache()
        return r

    record["inference"] = {attn: inference(primary, attn, attn == "pallas"
                                           and "MULTI" not in skip) for attn in attns}
    if "pallas" in record["inference"] and "multi_expression" in record["inference"]["pallas"]:
        record["multi_expression"] = record["inference"]["pallas"].pop("multi_expression")
    if not only:
        record["secondary"] = {"video-swin-t": inference("video-swin-t", attns[0], False)}
    if "TRAIN" not in skip:
        B = int(os.environ.get("BENCH_B", 1))
        train_iters = int(os.environ.get("BENCH_TRAIN_ITERS", 5))
        remat = os.environ.get("BENCH_REMAT") == "1"
        record["train"] = {"batch": B, "frames": 8, "remat": remat}
        for backbone in ([only] if only else ["video-swin-t", "video-swin-b"]):
            model = models.build(backbone, "xla", remat=remat)
            record["train"][backbone] = counted(measure_train, model, 8, B, train_iters)
            del model
            torch.cuda.empty_cache()
    head = record["inference"][attns[0]]["engine_u8"]["pipelined_fps"]
    record["value"], record["unit"] = head["median"], "frames/s"
    record["seconds"] = time.perf_counter() - t_start
    return record


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
