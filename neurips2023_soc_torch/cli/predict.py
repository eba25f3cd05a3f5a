"""Single-sample prediction (reference predict.py): one video file and one
expression through the model; the chosen trajectory's masks are saved as
PNGs. On the CUDA card unless `--device cpu`.

    python -m neurips2023_soc_torch.cli.predict -c configs/refer_youtube_vos.yaml \
        --video_path clip.mp4 --text "the dog on the left" -ckpt <reference .pth.tar>
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..config import load_config
from ..data.a2d_sentences import read_video_frames_cv2
from ..data.collate import normalize_frames
from ..data.transforms import VideoTransforms
from ..device import resolve_device
from ..inference import InferenceEngine
from ..models import build_model
from .infer_refytb import add_device_arg, load_params


def main(argv=None):
    parser = argparse.ArgumentParser("SOC predict")
    parser.add_argument("--config_path", "-c", default="configs/refer_youtube_vos.yaml")
    parser.add_argument("--video_path", required=True)
    parser.add_argument("--text", required=True)
    parser.add_argument("--checkpoint_path", "-ckpt", default=None)
    parser.add_argument("--output_dir", default="outputs/predict")
    args = add_device_arg(parser).parse_args(argv)
    config = load_config(args.config_path,
                         overrides={"checkpoint_path": args.checkpoint_path})
    device = resolve_device(args.device)

    video = read_video_frames_cv2(args.video_path)
    orig_size = video.shape[1:3]
    tr = VideoTransforms("test", eval_short_size=config.eval_short_size,
                         eval_max_size=config.eval_max_size)
    frames_list, _, _, text = tr(list(video), None, None, args.text)
    frames = normalize_frames(np.stack(frames_list))

    model = load_params(config, build_model(config, device=device))
    engine = InferenceEngine(model, text_encoder_type=config.text_encoder_type,
                             text_bucket=config.get("text_bucket", 32),
                             size_buckets=((frames.shape[1], frames.shape[2]),),
                             time_buckets=config.get("time_buckets"), device=device)
    masks = engine.infer_video(frames, text, original_size=orig_size)

    from PIL import Image

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    for t in range(masks.shape[0]):
        Image.fromarray(masks[t] * 255).save(out / f"{t:05d}.png")
    print(f"wrote {masks.shape[0]} masks to {out}")
    return masks


if __name__ == "__main__":
    main()
