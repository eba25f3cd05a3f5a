"""Per-dataset evaluation loops: forward -> postprocess -> metrics (the
port's counterpart of neurips2023_soc_tpu/evaluators.py, reference
trainer.py:252-354).

A2D/JHMDB: COCO-protocol mask mAP and P@K/IoU over centre-frame predictions.
RefCOCO pretraining: the same, plus box recall@k and box P@K.
Ref-YouTube-VOS: whole-video masks -> PNG tree -> submission zip (the valid
split has no public ground truth).

An evaluator built here is `evaluate(model, epoch) -> metrics`: it runs the
model in eval mode under torch.inference_mode() and gives the model back in
the mode it found. The batch loops keep the JAX package's three-stage
pipeline: the next batch is collated on the prefetch thread while this
batch's forward and device postprocess step run on the main thread, on the
current stream of the model's device; their results are queued into pinned
host memory behind a CUDA event, and one worker thread waits on that event
and does the previous batch's host postprocess (unpad, resize, RLE). At most
two batches are in flight.
"""
from __future__ import annotations

import json
from collections import deque
from contextlib import ExitStack, contextmanager
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from .evaluation.coco_eval import evaluate_coco_map, precision_at_k_and_iou
from .evaluation.rle import decode as rle_decode
from .evaluation.rle import encode as rle_encode
from .inference import _after_event, _host_worker, _to_host
from .models.postprocessing import (a2d_device_step, a2d_host_postprocess, a2d_postprocess,
                                    coco_topk_device_step)
from .training.train_step import device_batch
from .utils.logging import profile_trace
from .utils.prefetch import prefetch

MAX_IN_FLIGHT = 2  # batches whose host postprocess may still be pending


def build_a2d_gt_annotations(dataset) -> List[Dict]:
    """COCO-format GT from the dataset's centre-frame masks (reference
    datasets/a2d_sentences/create_gt_in_coco_format.py)."""
    gts = []
    for i in range(len(dataset)):
        s = dataset[i]
        mask = s["masks"][0, 0].astype(np.uint8)
        gts.append({"image_id": s["image_id"], "segmentation": rle_encode(mask),
                    "iscrowd": 0, "area": int(mask.sum())})
    return gts


def write_coco_gt_json(gt_annotations: List[Dict], out_path: str) -> None:
    """GT annotations as a pycocotools-loadable COCO dataset JSON in the
    reference's layout (create_gt_in_coco_format.py:43-95): dummy single
    category, one image per annotation, ascii RLE counts, xywh bbox. The
    reference's `dataset_coco_gt_format_path` config key names the file."""
    images, annotations = [], []
    for i, gt in enumerate(gt_annotations):
        rle = gt["segmentation"]
        h, w = rle["size"]
        images.append({"id": gt["image_id"], "height": int(h), "width": int(w)})
        ys, xs = np.nonzero(rle_decode(rle))
        bbox = ([float(xs.min()), float(ys.min()),
                 float(xs.max() - xs.min()), float(ys.max() - ys.min())]
                if len(xs) else [0.0, 0.0, 0.0, 0.0])
        counts = rle["counts"]
        annotations.append({
            "id": i + 1,
            "image_id": gt["image_id"],
            "category_id": 1,
            "segmentation": {"size": rle["size"],
                             "counts": counts.decode("ascii")
                             if isinstance(counts, bytes) else counts},
            "area": float(gt["area"]),
            "bbox": bbox,
            "iscrowd": int(gt.get("iscrowd", 0)),
        })
    out = {"categories": [{"id": 1, "name": "dummy_class"}],
           "images": images, "annotations": annotations}
    with open(out_path, "w") as f:
        json.dump(out, f)


@contextmanager
def evaluating(model: torch.nn.Module):
    """The model in eval mode under torch.inference_mode(); its mode is
    restored on the way out."""
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            yield
    finally:
        model.train(was_training)


def forward_batch(model: torch.nn.Module, batch: Dict) -> Dict[str, torch.Tensor]:
    """The model's inference forward on a collated host batch (its arrays go
    to the model's device; host metadata stays behind)."""
    b = device_batch(batch, next(model.parameters()).device)
    return model(b["pixels"], b["pad_mask"], b["text_ids"], b["text_mask"],
                 sample_sizes=b.get("sample_sizes"), valid_indices=b.get("valid_indices"),
                 training=False)


def _run_pipelined(model: torch.nn.Module, batches: Iterable[Dict], device_fn, host_fn) -> List:
    """host_fn(*host tensors, batch) for every batch, in order, where the host
    tensors are device_fn(outputs, batch)'s device tensors copied out. The
    forward and device_fn run here, on the current stream of the model's
    device; the copies are queued into pinned memory behind an event on that
    stream, and the worker thread (`_host_worker`, bound to the model's card)
    waits for the event before host_fn reads them (`_after_event`)."""
    device = next(model.parameters()).device
    results, pending = [], deque()
    with evaluating(model), _host_worker(device, "soc-eval-host") as ex:
        for batch in prefetch(batches):
            host = tuple(_to_host(t) for t in device_fn(forward_batch(model, batch), batch))
            event = None
            if device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(device))
            pending.append(ex.submit(_after_event, event, None, host_fn, *host, batch))
            if len(pending) > MAX_IN_FLIGHT:
                results.append(pending.popleft().result())
        results.extend(f.result() for f in pending)
    return results


def _a2d_device(outputs, batch):
    return a2d_device_step(outputs["pred_cls"][-1], outputs["pred_masks"][-1],
                           *batch["pixels"].shape[2:4])


def _mask_annotations(scores, masks, batch) -> List[Dict]:
    """One COCO detection per (annotated frame, query)."""
    preds = a2d_host_postprocess(scores, masks, batch["resized_sizes"], batch["orig_sizes"])
    return [{"image_id": image_id, "segmentation": p["rle_masks"][q], "score": float(s)}
            for image_id, p in zip(batch["image_ids"], preds)
            for q, s in enumerate(p["scores"])]


def evaluate_a2d_batches(model: torch.nn.Module, batches: Iterable[Dict],
                         gt_annotations: List[Dict],
                         calculate_pr: bool = True) -> Dict[str, float]:
    """Batches carry 'image_ids', 'resized_sizes' and 'orig_sizes' beside the
    model inputs. Every process's detections are gathered before the metrics
    (reference trainer.py:290-293 all_gather)."""
    from .parallel.multihost import gather_objects

    parts = _run_pipelined(model, batches, _a2d_device, _mask_annotations)
    dt_annotations = [a for part in gather_objects([a for p in parts for a in p])
                      for a in part]
    metrics = evaluate_coco_map(gt_annotations, dt_annotations)
    if calculate_pr:
        metrics.update(precision_at_k_and_iou(gt_annotations, dt_annotations))
    return metrics


def evaluate_coco_pretrain_batches(model: torch.nn.Module, batches: Iterable[Dict],
                                   gt_annotations: List[Dict],
                                   gt_boxes_by_img: Dict) -> Dict[str, float]:
    """RefCOCO pretrain validation (reference pretrainer.py:354-434): mask mAP
    and P@K/IoU by the COCO protocol, plus box recall@k and box P@K."""
    from .evaluation.refexp_eval import bbox_precision_at_k_and_iou, evaluate_refexp_recall

    def device_fn(outputs, batch):
        scores_k, _, boxes_k = coco_topk_device_step(outputs["pred_cls"][-1],
                                                     outputs["pred_boxes"][-1])
        return (*_a2d_device(outputs, batch), scores_k, boxes_k)

    def host_fn(scores, masks, scores_k, boxes_k, batch):
        boxes_by_img = {}
        for b, image_id in enumerate(batch["image_ids"]):
            oh, ow = batch["orig_sizes"][b]
            scale = np.array([ow, oh, ow, oh], np.float32)
            boxes_by_img[image_id] = [
                {"box": boxes_k[b, k].numpy() * scale, "score": float(scores_k[b, k])}
                for k in range(boxes_k.shape[1])]
        return _mask_annotations(scores, masks, batch), boxes_by_img

    dt_annotations: List[Dict] = []
    dt_boxes_by_img: Dict = {}
    for annos, boxes_by_img in _run_pipelined(model, batches, device_fn, host_fn):
        dt_annotations.extend(annos)
        dt_boxes_by_img.update(boxes_by_img)
    metrics = evaluate_coco_map(gt_annotations, dt_annotations)
    metrics.update(precision_at_k_and_iou(gt_annotations, dt_annotations))
    metrics.update(evaluate_refexp_recall(gt_boxes_by_img, dt_boxes_by_img))
    metrics.update(bbox_precision_at_k_and_iou(gt_boxes_by_img, dt_boxes_by_img))
    return metrics


def _batches(dataset, tokenizer, batch_size: int, shard: bool = False, **collate_kwargs):
    """Collated batches of `dataset` in order; `shard` keeps this rank's
    samples (rank::world), for an evaluator that gathers every rank's
    results (the reference's DistributedSampler over the val split)."""
    from .data.collate import collate_batch
    from .parallel.multihost import process_index_and_count

    rank, world = process_index_and_count() if shard else (0, 1)
    idx = range(rank, len(dataset), world)
    for start in range(0, len(idx), batch_size):
        samples = [dataset[i] for i in idx[start:start + batch_size]]
        yield collate_batch(samples, tokenizer, **collate_kwargs)


def build_a2d_evaluator(dataset, tokenizer, eval_batch_size: int = 4,
                        calculate_pr: bool = True, collate_kwargs: Optional[Dict] = None,
                        gt_json_path: Optional[str] = None) -> Callable:
    """Per-epoch A2D/JHMDB evaluation hook for the Trainer (reference
    trainer.py:252-313). Under a process group each rank evaluates its
    share of the split and the detections are gathered (every rank gets the
    same metrics). The GT annotations are built once and cached; with
    `gt_json_path` (the reference's `dataset_coco_gt_format_path`) the first
    process writes the COCO-format GT JSON there once."""
    from .parallel.multihost import is_main_process

    gt_cache: Dict[str, List[Dict]] = {}
    collate_kwargs = collate_kwargs or {}

    def evaluate(model: torch.nn.Module, epoch: int) -> Dict[str, float]:
        if "gt" not in gt_cache:
            gt_cache["gt"] = build_a2d_gt_annotations(dataset)
            if gt_json_path and not Path(gt_json_path).exists() and is_main_process():
                write_coco_gt_json(gt_cache["gt"], gt_json_path)
        return evaluate_a2d_batches(
            model, _batches(dataset, tokenizer, eval_batch_size, shard=True, **collate_kwargs),
            gt_cache["gt"], calculate_pr)

    return evaluate


# reference predict.py:13: the fixed overlay palette of `-rm pred`
_PRED_COLORS = ([212, 255, 127], [193, 182, 255], [106, 106, 255], [255, 206, 135])


def run_predict_visualize(model: torch.nn.Module, dataset, tokenizer, out_dir: str,
                          eval_batch_size: int = 4,
                          collate_kwargs: Optional[Dict] = None) -> int:
    """`-rm pred` (reference main.py:43 + predict.py:25-97): run the val split,
    overlay each sample's highest-scoring mask on its denormalized annotated
    frame at the original resolution, and save `out_dir/<video>/<image_id>.jpg`
    grouped per video. Returns the number of images written."""
    from PIL import Image

    from .data.collate import IMAGENET_MEAN, IMAGENET_STD
    from .utils.visualize import vis_add_mask

    out_root = Path(out_dir)
    out_root.mkdir(parents=True, exist_ok=True)
    written = 0
    with evaluating(model):
        for batch in _batches(dataset, tokenizer, eval_batch_size, **(collate_kwargs or {})):
            preds = a2d_postprocess(forward_batch(model, batch), batch["pixels"].shape[2:4],
                                    batch["resized_sizes"], batch["orig_sizes"])
            valid = batch.get("valid_indices", np.zeros(len(preds), int))
            for b, (image_id, p) in enumerate(zip(batch["image_ids"], preds)):
                mask = rle_decode(p["rle_masks"][int(np.argmax(p["scores"]))])
                # the annotated frame, denormalized, unpadded, resized to the original
                h, w = batch["resized_sizes"][b]
                frame = batch["pixels"][int(valid[b]), b, :h, :w]
                frame = np.clip((frame * IMAGENET_STD + IMAGENET_MEAN) * 255.0,
                                0, 255).astype(np.uint8)
                oh, ow = mask.shape
                img = Image.fromarray(frame).resize((ow, oh), Image.BILINEAR)
                over = vis_add_mask(np.asarray(img), mask,
                                    _PRED_COLORS[b % len(_PRED_COLORS)])
                # reference predict.py:44-45 groups files by the video of
                # 'v_<video>_f_<frame>_i_<inst>' ids; other ids stay flat
                parts = str(image_id).split("_")
                dst = out_root / parts[1] if len(parts) > 2 and parts[0] == "v" else out_root
                dst.mkdir(parents=True, exist_ok=True)
                Image.fromarray(over).save(dst / f"{image_id}.jpg")
                written += 1
    return written


def build_pretrain_evaluator(val_sets, tokenizer, eval_batch_size: int = 1,
                             size_buckets=None) -> Callable:
    """Per-epoch RefCOCO/+/g validation hook for the Trainer (reference
    pretrainer.py:262-286 and 354-434): every val split is evaluated each
    epoch, its metrics prefixed `{name}_`, and `mean_mask_mAP`, the mean of
    the splits' mask mAPs, selects the best checkpoint (pretrainer.py:234-238).

    val_sets: [(name, dataset)] of single-frame (T = 1) datasets."""
    from .data.coco_ref import build_refcoco_gt

    gt_cache: Dict[str, tuple] = {}
    collate_kwargs = dict(time_buckets=(1,))
    if size_buckets:
        collate_kwargs["size_buckets"] = size_buckets

    def evaluate(model: torch.nn.Module, epoch: int) -> Dict[str, float]:
        metrics: Dict[str, float] = {}
        maps = []
        for name, ds in val_sets:
            if name not in gt_cache:
                gt_cache[name] = build_refcoco_gt(ds)
            m = evaluate_coco_pretrain_batches(
                model, _batches(ds, tokenizer, eval_batch_size, **collate_kwargs),
                *gt_cache[name])
            maps.append(m.get("mAP 0.5:0.95", 0.0))
            metrics.update({f"{name}_{k}": v for k, v in m.items()})
        metrics["mean_mask_mAP"] = float(np.mean(maps)) if maps else 0.0
        return metrics

    return evaluate


def build_ytvos_evaluator(model: torch.nn.Module, config, dataset=None) -> Callable:
    """Per-epoch Ref-YouTube-VOS valid-split inference hook for the Trainer
    (reference trainer.py:315-354): whole-video inference per expression ->
    per-frame PNGs under `validation_outputs/epoch_{N}/Annotations/` ->
    `validation_outputs/submission_epoch_{N}.zip` for the competition server;
    the PNG tree is then removed. The zip path is the only "metric": the
    server computes J&F (the reference returns {} there).

    One engine on the model's device, or an EnginePool over every visible
    card when this single process sees more than one (a worker process per
    card, whose replica takes the model's weights once per epoch). With several processes
    the video groups are split between them; output_dir must then be shared,
    since rank 0 zips every process's PNGs."""
    import shutil
    import zipfile

    from .cli.infer_refytb import build_engine
    from .inference import EnginePool, eval_size_buckets, shard_videos
    from .parallel.multihost import barrier, is_main_process

    state: Dict = {"ds": dataset}

    def evaluate(model: torch.nn.Module, epoch: int) -> Dict[str, str]:
        if state["ds"] is None:
            from .data.refer_youtube_vos import ReferYouTubeVOSDataset

            state["ds"] = ReferYouTubeVOSDataset(
                "test", config.img_folder,
                check_counts=bool(config.get("check_dataset_counts", True)),
                transforms_kwargs=dict(eval_short_size=config.eval_short_size,
                                       eval_max_size=config.eval_max_size))
        distributed = torch.distributed.is_available() and torch.distributed.is_initialized()
        device = next(model.parameters()).device
        out_root = Path(config.get("output_dir")
                        or f"outputs/{config.dataset_name}") / "validation_outputs"
        epoch_dir = out_root / f"epoch_{epoch}"
        ds = state["ds"]
        # a video's expressions stay in one process and share its backbone run
        groups = list(ds.video_groups().values())
        if distributed:
            groups = shard_videos(groups)
        was_training = model.training  # building an engine puts the model in eval mode
        try:
            if "engine" not in state:
                # both orientations: portrait videos take the transposed bucket
                state["engine"] = build_engine(
                    config, model, device,
                    eval_size_buckets(config.eval_short_size, config.eval_max_size),
                    time_buckets_key="eval_time_buckets")
            engine = state["engine"]
            if isinstance(engine, EnginePool):
                engine.update_params(model.state_dict())
            with evaluating(model):
                evaluate_refer_youtube_vos(engine, ds, str(epoch_dir), make_zip=False,
                                           groups=groups)
        finally:
            model.train(was_training)
        barrier("ytvos_eval_pngs")  # every process has written its PNGs
        zip_path = out_root / f"submission_epoch_{epoch}.zip"
        if is_main_process():
            with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
                for p in sorted((epoch_dir / "Annotations").rglob("*.png")):
                    zf.write(p, p.relative_to(epoch_dir))
            shutil.rmtree(epoch_dir)  # reference trainer.py:350
        barrier("ytvos_eval_zip")
        return {"submission_zip": str(zip_path)}

    return evaluate


def evaluate_refer_youtube_vos(engine, dataset, output_dir: str, make_zip: bool = True,
                               visualize_dir: str = None, frame_path_fn=None,
                               groups=None, profile_videos: int = 0) -> Dict[str, str]:
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
    rank 0 writes the zip after a barrier, so output_dir must be shared.

    profile_videos = N > 0 writes a torch.profiler trace (profile_trace) of
    this process from the decode of video 1 to the PNGs of video N (video 0
    warms up) under output_dir/profile."""
    from .inference import run_videos_pipelined, save_ytvos_predictions, zip_submission
    from .parallel.multihost import barrier, is_main_process

    if groups is None:
        groups = list(dataset.video_groups().values())
    trace = ExitStack()

    def item_fn(w):
        """Decode one video group into infer_video_multi kwargs; it runs
        inside the pipelined loop, so the next group's decode overlaps this
        one's device work."""
        if profile_videos and w["i"] == 1:
            trace.enter_context(profile_trace(str(Path(output_dir) / "profile")))
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
        if w["i"] == profile_videos:
            trace.close()

    with trace:  # also closes a trace of more videos than there are
        run_videos_pipelined(engine, [{"g": g, "i": i} for i, g in enumerate(groups)],
                             item_fn, post_fn)
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
