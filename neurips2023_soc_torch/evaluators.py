"""Evaluation drivers (the port's counterpart of
neurips2023_soc_tpu/evaluators.py, reference trainer.py:252-354). This slice
has the Ref-YouTube-VOS one: whole-video masks -> PNG tree -> submission zip
(the valid split has no public ground truth). The A2D/JHMDB and COCO
evaluators, and the Ref-YouTube-VOS evaluation during training, come later.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np


def evaluate_refer_youtube_vos(engine, dataset, output_dir: str, make_zip: bool = True,
                               visualize_dir: str = None, frame_path_fn=None,
                               groups=None) -> Dict[str, str]:
    """Whole-video inference over the valid split, written as the competition
    submission (reference trainer.py:315-354).

    `dataset` is a ReferYouTubeVOSDataset (test split). Expressions of one
    video share the decoded frames and the text-independent backbone: samples
    are grouped by video (dataset.video_groups(), or the `groups` index lists
    a multi-process caller sharded), each group is decoded once and runs
    InferenceEngine.infer_video_multi.

    With visualize_dir and frame_path_fn(video_id, frame_name) -> jpg path,
    box + mask overlays on the original frames are written too, one palette
    color per expression (reference infer_refytb.py --visualize, 240-266).

    Several processes: callers shard the groups per process (shard_videos);
    rank 0 writes the zip after a barrier, so output_dir must be shared."""
    from .inference import run_videos_pipelined, save_ytvos_predictions, zip_submission
    from .parallel.multihost import barrier, is_main_process

    if groups is None:
        groups = list(dataset.video_groups().values())

    def item_fn(w):
        """Decode one video group into infer_video_multi kwargs; it runs
        inside the pipelined loop, so the next group's decode overlaps this
        one's device work."""
        g = w["g"]
        s = dataset[g[0]]
        meta0 = s["video_metadata"]
        w["metas"] = [{**meta0, "exp_id": dataset.exp_id(i)} for i in g]
        return dict(frames=s["frames"], texts=[dataset.get_text(i) for i in g],
                    original_size=meta0["original_frame_size"],
                    return_boxes=visualize_dir is not None)

    def post_fn(w, results):
        """Write this video's PNGs at once, while the next video runs."""
        preds = []
        for meta, r in zip(w["metas"], results):
            if visualize_dir is not None:
                masks, boxes = r
                _save_ytvos_overlays(meta, masks, boxes, visualize_dir, frame_path_fn)
            else:
                masks = r
            preds.append({**meta, "pred_masks": masks})
        save_ytvos_predictions(preds, output_dir)

    run_videos_pipelined(engine, [{"g": g} for g in groups], item_fn, post_fn)
    out = {"predictions_dir": output_dir}
    if make_zip:
        barrier("ytvos_submission_pngs")  # every process has written its PNGs
        if is_main_process():
            out["submission_zip"] = zip_submission(output_dir)
        barrier("ytvos_submission_zip")
    return out


def _save_ytvos_overlays(meta, masks, boxes, visualize_dir, frame_path_fn):
    """Box + mask overlays on the original frames, colored by expression id
    (reference infer_refytb.py:240-266: {split}_images/{video}/{exp}/)."""
    from PIL import Image

    from .utils.visualize import overlay_prediction

    d = Path(visualize_dir) / meta["video_id"] / meta["exp_id"]
    d.mkdir(parents=True, exist_ok=True)
    color_index = int(meta["exp_id"]) if str(meta["exp_id"]).isdigit() else 0
    for t, frame in enumerate(meta["frame_indices"]):
        img = np.asarray(Image.open(frame_path_fn(meta["video_id"], frame)).convert("RGB"))
        out = overlay_prediction(img, masks[t], boxes[t], color_index)
        Image.fromarray(out).save(d / f"{frame}.png")
