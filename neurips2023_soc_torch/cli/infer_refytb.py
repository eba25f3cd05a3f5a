"""Ref-YouTube-VOS valid-set inference and submission zip (reference
infer_refytb.py), on the CUDA card:

    python -m neurips2023_soc_torch.cli.infer_refytb -c configs/refer_youtube_vos.yaml \
        -ckpt <reference .pth.tar> --output_dir outputs/ytvos_valid

`swin_attn_impl: pallas` in the config runs the backbone's window attention
through kernel K3. Several visible cards run one engine each (EnginePool);
several processes (torch.distributed) split the videos. `--device cpu` runs
on the CPU.

The config's `profile_steps: N` writes a torch.profiler trace of videos
1..N (a Chrome trace under output_dir/profile) with the engine's and the
model's `soc.*` spans beside the kernels. Over several cards it holds this
process only: the EnginePool's workers, which run the model, are not in it.
"""
from __future__ import annotations

import argparse
import time
from os import path as osp
from pathlib import Path

import torch

from ..config import add_config_args, config_from_args
from ..data.refer_youtube_vos import ReferYouTubeVOSDataset
from ..device import resolve_device
from ..evaluators import evaluate_refer_youtube_vos
from ..inference import EnginePool, InferenceEngine, eval_size_buckets, shard_videos
from ..models import build_model
from ..parallel import initialize_distributed
from ..training.checkpoint import load_torch_checkpoint


def load_params(config, model: torch.nn.Module) -> torch.nn.Module:
    """Loads `checkpoint_path`, a reference-layout `.pth.tar` (or a bare
    state_dict file), into `model` with strict key matching; without one the
    model keeps its seeded initialization. A directory is refused: that is
    an orbax checkpoint, the JAX package's format."""
    ckpt = config.get("checkpoint_path")
    if ckpt:
        if Path(ckpt).is_dir():
            raise ValueError(
                f"{ckpt} is a directory, an orbax checkpoint of the JAX package; the "
                "port loads a reference-layout .pth.tar (export one with the JAX "
                "package's training/convert.py or the port's "
                "training.save_reference_checkpoint)")
        model.load_state_dict(load_torch_checkpoint(ckpt), strict=True)
    return model


def add_device_arg(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--device", default="cuda",
                        help="where the model runs: cuda (default) or cpu")
    return parser


def build_engine(config, model, device: torch.device, size_buckets,
                 time_buckets_key: str = "time_buckets"):
    """One engine on `device`, or an EnginePool over every visible card when
    this single process sees more than one (a worker process per card; close
    it when done). The engine's time buckets are the config's
    `time_buckets_key` entry (the engine's default when unset)."""
    kwargs = dict(text_encoder_type=config.text_encoder_type,
                  text_bucket=config.get("text_bucket", 32),
                  time_buckets=config.get(time_buckets_key), size_buckets=size_buckets,
                  pixel_format=config.get("pixel_format", "auto"),
                  probs_dtype=config.get("probs_dtype", "float32"))
    distributed = torch.distributed.is_available() and torch.distributed.is_initialized()
    if device.type == "cuda" and not distributed and torch.cuda.device_count() > 1:
        return EnginePool(model, **kwargs)
    if device.type == "cuda" and distributed:
        device = torch.device("cuda", torch.cuda.current_device())
    return InferenceEngine(model, device=device, **kwargs)


def main(argv=None):
    parser = add_config_args(argparse.ArgumentParser("Ref-YTVOS inference"))
    parser.add_argument("--visualize", action="store_true",
                        help="also write box + mask overlays on the original frames "
                             "(reference infer_refytb.py --visualize)")
    args = add_device_arg(parser).parse_args(argv)
    config = config_from_args(args)
    device = resolve_device(args.device)
    distributed = initialize_distributed(config)
    dataset = ReferYouTubeVOSDataset(
        "test", config.img_folder,
        # the 202-video competition check applies to the real corpus only
        check_counts=bool(config.get("check_dataset_counts", True)),
        transforms_kwargs=dict(eval_short_size=config.eval_short_size,
                               eval_max_size=config.eval_max_size))
    model = load_params(config, build_model(config, device=device))
    size_buckets = tuple(tuple(b) for b in (
        config.get("eval_size_buckets")
        or eval_size_buckets(config.eval_short_size, config.eval_max_size)))
    engine = build_engine(config, model, device, size_buckets)
    out_dir = config.get("output_dir") or "outputs/ytvos_valid"
    t0 = time.time()
    # every group's expressions stay in one process, so the shared backbone
    # runs once per group
    groups = list(dataset.video_groups().values())
    if distributed:
        groups = shard_videos(groups)
    vis_kwargs = {}
    if config.get("visualize"):
        vis_kwargs = dict(
            visualize_dir=osp.join(out_dir, "valid_images"),  # reference infer_refytb.py:61
            frame_path_fn=lambda vid, frame: osp.join(
                config.img_folder, "valid", "JPEGImages", vid, frame + ".jpg"))
    try:
        result = evaluate_refer_youtube_vos(
            engine, dataset, out_dir, groups=groups,
            profile_videos=int(config.get("profile_steps", 0) or 0), **vis_kwargs)
    finally:
        if isinstance(engine, EnginePool):
            engine.close()
    print(f"done in {time.time() - t0:.1f}s -> {result}")
    return result


if __name__ == "__main__":
    main()
