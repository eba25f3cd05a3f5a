"""RefCOCO/+/g pretraining entry point (reference main_pretrain.py and
pretrainer.py), on the CUDA card:

    python -m neurips2023_soc_torch.cli.main_pretrain -c configs/refcoco_pretrain.yaml

The three RefCOCO train sets are concatenated as single frames (T = 1) and
trained with the standard step; each epoch reports mask mAP, P@K and IoU and
box recall@k on every val split on disk. Modes `train`, `resume_train` and
`test`; `--device cpu` runs on the CPU.
"""
from __future__ import annotations

import argparse
from os import path

from ..config import add_config_args, config_from_args
from ..data.coco_ref import ConcatClipDataset, RefCOCOClipDataset
from ..device import resolve_device
from ..models.text_encoder import build_tokenizer
from ..parallel import initialize_distributed
from ..training.trainer import Trainer
from ..utils.logging import setup_for_distributed
from ..utils.padded import train_size_buckets
from .infer_refytb import add_device_arg
from .main import load_or_init, make_batch_iterator, train_transforms_kwargs

REFCOCO_ANN_FILES = {
    "refcoco": "finetune_refcoco_train.json",
    "refcoco+": "finetune_refcoco+_train.json",
    "refcocog": "finetune_refcocog_train.json",
}


def build_pretrain_dataset(config, as_clip: bool = False):
    """as_clip=False (pretraining): single-frame samples, as the reference
    pretrainer trains on refercoco.ModulatedDetection images
    (pretrainer.py:67-73, refercoco.py:49-50 'T = 1'). as_clip=True (joint
    training): 8-frame pseudo-videos through the warp augmenter, as the joint
    trainer's ref2seq datasets."""
    parts = []
    for ann in REFCOCO_ANN_FILES.values():
        ann_path = path.join(config.img_folder, "annotations", ann)
        if path.exists(ann_path):
            parts.append(RefCOCOClipDataset(
                ann_path, path.join(config.img_folder, "train2014"),
                num_frames=config.window_size, transforms_kwargs=train_transforms_kwargs(config),
                seed=config.seed, as_clip=as_clip))
    assert parts, f"no refcoco annotation files under {config.img_folder}/annotations"
    return ConcatClipDataset(parts)


def build_pretrain_evaluate_fn(config, tokenizer, val_sets=None):
    """Per-epoch validation over `val_sets` [(name, dataset)], by default
    every RefCOCO split whose val json exists (reference pretrainer.py:87-108
    builds them, 262-286 runs them each epoch). None without val sets."""
    from ..data.coco_ref import build_refcoco_val_datasets
    from ..evaluators import build_pretrain_evaluator

    if val_sets is None:
        val_sets = build_refcoco_val_datasets(config)
    if not val_sets:
        print("no RefCOCO val annotation files found: the best checkpoint is by train loss")
        return None
    print(f"pretrain validation on: {[name for name, _ in val_sets]}")
    # COCO val images mix orientations within an eval batch: the square
    # bucket takes mixed batches
    return build_pretrain_evaluator(
        val_sets, tokenizer, eval_batch_size=config.eval_batch_size,
        size_buckets=train_size_buckets(config.eval_short_size, config.eval_max_size))


def run(config, running_mode: str, train_dataset=None, val_sets=None, device=None):
    """main() after parsing: `train_dataset` None builds the single-frame
    RefCOCO train sets, `val_sets` None the val splits on disk; `device` None
    is the CUDA card. Returns (trainer, the metrics for `test`, else None)."""
    device = resolve_device(device)
    initialize_distributed(config)
    setup_for_distributed()
    tokenizer = build_tokenizer(config.text_encoder_type, config.get("text_bucket", 32))
    dataset = train_dataset if train_dataset is not None else build_pretrain_dataset(config)
    trainer = Trainer(
        config,
        train_batches=make_batch_iterator(dataset, config, tokenizer, time_buckets=(1,)),
        steps_per_epoch=len(dataset) // config.batch_size,
        evaluate_fn=build_pretrain_evaluate_fn(config, tokenizer, val_sets), device=device)
    result = None
    if running_mode == "train":
        trainer.train()
    elif running_mode == "resume_train":
        trainer.load_checkpoint(path=config.get("checkpoint_path") or None)
        trainer.train()
    elif running_mode == "test":
        if trainer.evaluate_fn is None:
            raise SystemExit("no RefCOCO val annotations found: nothing to evaluate")
        load_or_init(trainer, config)
        result = trainer.evaluate_fn(trainer.model, 0)
        print(result)
    else:
        raise ValueError(f"main_pretrain runs train, resume_train or test, not {running_mode}")
    return trainer, result


def main(argv=None):
    parser = add_config_args(argparse.ArgumentParser("SOC RefCOCO pretraining"), training=True)
    args = add_device_arg(parser).parse_args(argv)
    return run(config_from_args(args), args.running_mode, device=args.device)


if __name__ == "__main__":
    main()
