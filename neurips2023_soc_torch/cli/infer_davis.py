"""Ref-DAVIS-17 inference (reference infer_davis.py), on the CUDA card:

    python -m neurips2023_soc_torch.cli.infer_davis -c configs/davis.yaml \
        -ckpt <reference .pth.tar> --output_dir outputs/davis_valid

Expressions are grouped 4 per object; per annotation variant the objects'
probability masks are merged by an argmax with a 0.1 background channel
and written as palette PNGs `anno_<k>/<video>/<frame>.png`, which
`cli/eval_davis.py` scores. Each video runs whole, in chunks of the largest
time bucket, with the trajectory chosen per chunk (reference
infer_davis.py:242-247). Several visible cards run one engine each
(EnginePool); several processes (torch.distributed) split the videos.
`--device cpu` runs on the CPU; without a card the default raises.

`davis_videos`, `item_fn` and `merge_annotators` are what the loop runs per
video, kept at module level so that other callers run the same code; only
`post_fn` writes files (PIL).
"""
from __future__ import annotations

import argparse
import functools
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..config import add_config_args, config_from_args
from ..data.davis import ReferDAVISDataset
from ..device import resolve_device
from ..inference import (EnginePool, eval_size_buckets, group_davis_annotator_order,
                         merge_davis_annotator, run_videos_pipelined,
                         save_davis_annotator_masks, shard_videos)
from ..models import build_model
from ..parallel import initialize_distributed
from .infer_refytb import add_device_arg, build_engine, load_params

NUM_ANNOTATIONS = 4  # expressions per object: 2 annotators x (first frame, full video)


def davis_videos(dataset) -> List[Dict]:
    """This process's videos, each {"video_id", "order"}: its expression
    indices in annotator-major order. The converted meta_expressions layout
    is object-major (exp id = obj * 4 + anno, reference
    convert_davis_to_ytbs.py:165-177 and infer_davis.py:199), so each
    annotation variant's objects become one run of num_obj."""
    by_video = defaultdict(list)
    for i, (video_id, _, _) in enumerate(dataset.samples_list):
        by_video[video_id].append(i)
    videos = []
    for video_id in shard_videos(sorted(by_video)):
        idxs = sorted(by_video[video_id],
                      key=lambda i: int(dataset.samples_list[i][2]["exp_id"]))
        videos.append({"video_id": video_id, "order": group_davis_annotator_order(idxs)})
    return videos


def item_fn(dataset, w: Dict) -> Dict:
    """Decode one video once for all its expressions (the pipelined loop
    overlaps this with the previous video's device work): infer_video_multi
    kwargs for per-chunk trajectories and probabilities."""
    s = dataset[w["order"][0]]
    w["frame_names"] = s["video_metadata"]["frame_indices"]
    return dict(frames=s["frames"], texts=[dataset.get_text(i) for i in w["order"]],
                original_size=s["video_metadata"]["original_frame_size"],
                return_probs=True, trajectory="chunk")


def merge_annotators(w: Dict, all_probs: List[np.ndarray]) -> List[np.ndarray]:
    """One video's probabilities (annotator-major, as `order`) -> one
    (T, H, W) uint8 index mask per annotation variant."""
    num_obj = len(w["order"]) // NUM_ANNOTATIONS
    return [merge_davis_annotator(all_probs[a * num_obj:(a + 1) * num_obj])
            for a in range(NUM_ANNOTATIONS)]


def post_fn(out_root: Path, frames_dir: Optional[Path], t0: float, w: Dict,
            all_probs: List[np.ndarray]) -> None:
    """Merge and write all four annotation variants' PNGs of one video (runs
    while the next video computes on the device); with `frames_dir`, also the
    per-object overlays on the original frames."""
    from PIL import Image

    from ..utils.visualize import vis_add_index_mask

    video_id, frame_names = w["video_id"], w["frame_names"]
    raw_frames = None
    if frames_dir is not None:  # each original JPEG decoded once per video
        raw_frames = [np.asarray(Image.open(frames_dir / video_id / f"{name}.jpg")
                                 .convert("RGB")) for name in frame_names]
    for anno_id, merged in enumerate(merge_annotators(w, all_probs)):
        save_davis_annotator_masks(merged, str(out_root / f"anno_{anno_id}" / video_id),
                                   frame_names)
        if raw_frames is not None:
            # reference infer_davis.py:274-283 ({split}_images tree); each object id
            # gets its own palette color
            vd = out_root / "valid_images" / f"anno_{anno_id}" / video_id
            vd.mkdir(parents=True, exist_ok=True)
            for t, name in enumerate(frame_names):
                Image.fromarray(vis_add_index_mask(raw_frames[t], merged[t])).save(
                    vd / f"{name}.png")
    print(f"{video_id}: done ({time.time() - t0:.1f}s elapsed)", flush=True)


def main(argv=None) -> Path:
    parser = add_config_args(argparse.ArgumentParser("Ref-DAVIS inference"))
    parser.add_argument("--visualize", action="store_true",
                        help="also write per-object mask overlays on the original frames "
                             "(reference infer_davis.py --visualize)")
    args = add_device_arg(parser).parse_args(argv)
    config = config_from_args(args)
    device = resolve_device(args.device)
    initialize_distributed(config)  # several processes split the videos
    dataset = ReferDAVISDataset(
        "valid", config.img_folder,
        transforms_kwargs=dict(eval_short_size=config.eval_short_size,
                               eval_max_size=config.eval_max_size))
    model = load_params(config, build_model(config, device=device))
    size_buckets = tuple(tuple(b) for b in (
        config.get("eval_size_buckets")
        or eval_size_buckets(config.eval_short_size, config.eval_max_size)))
    engine = build_engine(config, model, device, size_buckets)
    out_root = Path(config.get("output_dir") or "outputs/davis_valid")
    frames_dir = (Path(config.img_folder) / "valid" / "JPEGImages"
                  if config.get("visualize") else None)
    try:
        run_videos_pipelined(engine, davis_videos(dataset), functools.partial(item_fn, dataset),
                             functools.partial(post_fn, out_root, frames_dir, time.time()))
    finally:
        if isinstance(engine, EnginePool):
            engine.close()
    return out_root


if __name__ == "__main__":
    main()
