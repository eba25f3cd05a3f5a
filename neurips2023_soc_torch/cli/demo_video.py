"""Single-video referring segmentation demo (reference demo_video.py): read
a video file (every Nth frame), run one whole-clip forward, overlay the
chosen trajectory's masks and save PNGs. `--synthetic` runs on a generated
clip, so the demo needs no data. On the CUDA card unless `--device cpu`.

    python -m neurips2023_soc_torch.cli.demo_video --synthetic
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..config import load_config
from ..data.collate import IMAGENET_MEAN, IMAGENET_STD, normalize_frames
from ..device import resolve_device
from ..inference import InferenceEngine
from ..models import build_model
from .infer_refytb import add_device_arg, load_params


def overlay(frame_u8: np.ndarray, mask: np.ndarray, color=(255, 60, 60),
            alpha=0.5) -> np.ndarray:
    out = frame_u8.astype(np.float32)
    m = mask.astype(bool)
    out[m] = (1 - alpha) * out[m] + alpha * np.asarray(color, np.float32)
    return out.astype(np.uint8)


def main(argv=None):
    parser = argparse.ArgumentParser("SOC demo")
    parser.add_argument("--config_path", "-c", default="configs/refer_youtube_vos.yaml")
    parser.add_argument("--video_path", default=None)
    parser.add_argument("--text", default="the red square moving right")
    parser.add_argument("--checkpoint_path", "-ckpt", default=None)
    parser.add_argument("--backbone", "-b", default=None)
    parser.add_argument("--output_dir", default="outputs/demo")
    parser.add_argument("--frame_stride", type=int, default=5)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--synthetic_frames", type=int, default=8)
    parser.add_argument("--synthetic_size", type=int, nargs=2, default=(160, 288),
                        metavar=("H", "W"))
    args = add_device_arg(parser).parse_args(argv)
    config = load_config(args.config_path, overrides={
        "checkpoint_path": args.checkpoint_path, "backbone": args.backbone})
    device = resolve_device(args.device)

    if args.synthetic:
        from ..data.synthetic import SyntheticRVOSDataset

        s = SyntheticRVOSDataset(num_samples=1, num_frames=args.synthetic_frames,
                                 frame_size=tuple(args.synthetic_size))[0]
        frames, text = s["frames"], s["text"]
        raw = ((frames * IMAGENET_STD + IMAGENET_MEAN) * 255).clip(0, 255).astype(np.uint8)
    else:
        from ..data.a2d_sentences import read_video_frames_cv2
        from ..data.transforms import VideoTransforms

        video = read_video_frames_cv2(args.video_path)[:: args.frame_stride]
        raw = (video * 255).astype(np.uint8)
        tr = VideoTransforms("test", eval_short_size=config.eval_short_size,
                             eval_max_size=config.eval_max_size)
        frames_list, _, _, text = tr(list(video), None, None, args.text)
        frames = normalize_frames(np.stack(frames_list))

    model = load_params(config, build_model(config, device=device))
    engine = InferenceEngine(model, text_encoder_type=config.text_encoder_type,
                             text_bucket=config.get("text_bucket", 32),
                             size_buckets=((frames.shape[1], frames.shape[2]),),
                             time_buckets=config.get("time_buckets"), device=device)
    masks = engine.infer_video(frames, text, original_size=raw.shape[1:3])

    from PIL import Image

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    for t in range(masks.shape[0]):
        Image.fromarray(overlay(raw[t], masks[t])).save(out / f"{t:05d}.png")
    print(f'text: "{text}"')
    print(f"wrote {masks.shape[0]} overlay frames to {out} "
          f"(mask coverage {masks.mean():.3f})")
    return masks


if __name__ == "__main__":
    main()
