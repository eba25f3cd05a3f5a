"""Training and evaluation entry point (reference main.py), on the CUDA card:

    python -m neurips2023_soc_torch.cli.main -c configs/a2d_sentences.yaml -rm train
    torchrun --nproc_per_node 8 -m neurips2023_soc_torch.cli.main -c configs/a2d_sentences.yaml

Under torchrun each rank trains on its share of every global batch
(DistributedDataParallel; `optimizer_sharding: zero1` shards AdamW's state),
on NCCL unless `dist_backend` / DIST_BACKEND says gloo; ranks other than 0
print nothing unless asked to (`print(..., force=True)`).

Modes: `train`, `resume_train` (from `-ckpt`, else the latest epoch under
output_dir), `test` (the per-epoch evaluator once, on the `-ckpt` weights) and
`pred` (A2D/JHMDB: the val split's best masks drawn on its frames). `--device
cpu` runs on the CPU. `run` is the body of `main` without the parsing: a
caller may hand it datasets of its own.
"""
from __future__ import annotations

import argparse
from os import path
from typing import Optional

from ..config import add_config_args, config_from_args
from ..data.collate import collate_batch
from ..device import resolve_device
from ..models.text_encoder import build_tokenizer
from ..parallel import initialize_distributed, process_index_and_count
from ..training.trainer import Trainer, check_batch_divides
from ..utils.logging import setup_for_distributed
from ..utils.padded import train_size_buckets
from .infer_refytb import add_device_arg


def train_transforms_kwargs(config) -> dict:
    return dict(
        horizontal_flip_augmentations=config.horizontal_flip_augmentations,
        resize_and_crop_augmentations=config.resize_and_crop_augmentations,
        random_color=config.random_color,
        train_short_size=config.train_short_size,
        train_max_size=config.train_max_size,
        eval_short_size=config.eval_short_size,
        eval_max_size=config.eval_max_size,
        seed=config.seed,
    )


def build_train_dataset(config):
    name = config.dataset_name
    if name == "ref_youtube_vos":
        from ..data.refer_youtube_vos import ReferYouTubeVOSDataset

        return ReferYouTubeVOSDataset(
            "train", config.img_folder, window_size=config.window_size,
            check_counts=bool(config.get("check_dataset_counts", True)),
            transforms_kwargs=train_transforms_kwargs(config))
    if name == "a2d_sentences":
        from ..data.a2d_sentences import A2DSentencesDataset

        return A2DSentencesDataset(
            "train", config.img_folder, window_size=config.window_size,
            transforms_kwargs=train_transforms_kwargs(config),
            force_rebuild_metadata=bool(config.get("generate_new_samples_metadata", False)))
    if name == "synthetic":
        from ..data.synthetic import SyntheticRVOSDataset

        return SyntheticRVOSDataset(num_samples=config.get("num_samples", 64),
                                    num_frames=config.window_size)
    raise ValueError(f"unsupported train dataset {name}")


def make_batch_iterator(dataset, config, tokenizer, num_hosts: Optional[int] = None,
                        host_id: Optional[int] = None, time_buckets=None):
    """train_batches(epoch): the epoch's shuffled local batches.

    Sharding (reference trainer.py:74-82, DistributedSampler): every process
    computes the same epoch permutation and takes its `host_id::num_hosts`
    stride, batch_size / num_hosts samples per local batch; the k-th local
    batches of all processes make the k-th global batch. Rank and world size
    default to torch.distributed's (0 and 1 without a process group).

    Loading (reference trainer.py:82-88, DataLoader(num_workers)): the
    samples decode on config.num_workers threads, in order, so the batches do
    not depend on the worker count. The ragged tail is dropped. Batches pad to
    the buckets of the training sizes (both orientations and the square for
    mixed batches) and to `time_buckets` (default: the window; pretraining
    passes (1,), its samples being single frames)."""
    from ..data.sampler import ShardedEpochSampler
    from ..utils.prefetch import parallel_map

    size_buckets = train_size_buckets(config.train_short_size, config.train_max_size)
    time_buckets = time_buckets or (config.window_size,)
    rank, world = process_index_and_count()
    num_hosts = world if num_hosts is None else num_hosts
    host_id = rank if host_id is None else host_id
    bs = int(config.batch_size)
    check_batch_divides(bs, num_hosts)
    local_bs = bs // num_hosts
    num_workers = int(config.get("num_workers", 0) or 0)
    sampler = ShardedEpochSampler(len(dataset), num_hosts, host_id, shuffle=True,
                                  seed=config.seed)

    def train_batches(epoch: int):
        sampler.set_epoch(epoch)
        if hasattr(dataset, "set_epoch"):  # the per-(epoch, idx) augmentation streams
            dataset.set_epoch(epoch)
        order = list(sampler)
        order = order[: (len(order) // local_bs) * local_bs]
        batch = []
        for s in parallel_map(dataset.__getitem__, order, num_workers):
            batch.append(s)
            if len(batch) == local_bs:
                yield collate_batch(batch, tokenizer, size_buckets=size_buckets,
                                    time_buckets=time_buckets)
                batch = []

    return train_batches


def _eval_tk(config) -> dict:
    return dict(eval_short_size=config.eval_short_size, eval_max_size=config.eval_max_size)


def _eval_size_buckets(config):
    """Both orientations and the square bucket, for eval batches that mix
    them (eval_batch_size > 1)."""
    return train_size_buckets(config.eval_short_size, config.eval_max_size)


def build_a2d_style_val_dataset(config):
    """The A2D/JHMDB val split, for the per-epoch evaluator and `-rm pred`."""
    rebuild = bool(config.get("generate_new_samples_metadata", False))
    if config.dataset_name == "a2d_sentences":
        from ..data.a2d_sentences import A2DSentencesDataset

        return A2DSentencesDataset("test", config.img_folder, window_size=config.window_size,
                                   transforms_kwargs=_eval_tk(config),
                                   force_rebuild_metadata=rebuild)
    from ..data.jhmdb_sentences import JHMDBSentencesDataset

    return JHMDBSentencesDataset("test", config.img_folder, window_size=config.window_size,
                                 transforms_kwargs=_eval_tk(config),
                                 force_rebuild_metadata=rebuild)


def build_evaluator(config, tokenizer, model=None, val_dataset=None):
    """The per-epoch evaluation hook. A2D/JHMDB: COCO-protocol mAP over
    `val_dataset` (the config's val split when None). Ref-YouTube-VOS: the
    reference's valid-split inference -> PNG masks -> submission zip every
    epoch (trainer.py:315-354; the split has no public ground truth, so the
    best checkpoint stays by train loss), when the valid split is on disk.
    None for other datasets."""
    name = config.dataset_name
    if name in ("a2d_sentences", "jhmdb_sentences"):
        from ..evaluators import build_a2d_evaluator

        val = val_dataset if val_dataset is not None else build_a2d_style_val_dataset(config)
        return build_a2d_evaluator(
            val, tokenizer, eval_batch_size=config.eval_batch_size,
            collate_kwargs=dict(size_buckets=_eval_size_buckets(config)),
            # reference config keys (trainer.py:306, create_gt_in_coco_format)
            calculate_pr=config.get("calculate_precision_and_iou_metrics", True),
            gt_json_path=config.get("dataset_coco_gt_format_path") or None)
    if name == "ref_youtube_vos" and model is not None:
        return build_ytvos_evaluator_if_on_disk(config, model)
    return None


def build_ytvos_evaluator_if_on_disk(config, model):
    from ..evaluators import build_ytvos_evaluator

    if not path.exists(path.join(config.img_folder, "valid")):
        print(f"Ref-YTVOS valid split not found under {config.img_folder}: no per-epoch eval")
        return None
    return build_ytvos_evaluator(model, config)


def load_or_init(trainer: Trainer, config) -> None:
    """`-ckpt` as the model's weights (strict), else the trainer's own
    initialization with its `pretrained_weights` warm start."""
    if config.get("checkpoint_path"):
        trainer.load_weights(config.checkpoint_path)
    else:
        trainer.init_state()


def run(config, running_mode: str, train_dataset=None, val_dataset=None, device=None):
    """main() after parsing. `train_dataset` / `val_dataset` None build the
    config's splits; `device` None is the CUDA card. Returns (trainer,
    result): the metrics for `test`, the number of images written for
    `pred`, else None."""
    device = resolve_device(device)
    initialize_distributed(config)
    setup_for_distributed()
    tokenizer = build_tokenizer(config.text_encoder_type, config.get("text_bucket", 32))
    dataset = train_dataset if train_dataset is not None else build_train_dataset(config)
    trainer = Trainer(config, train_batches=make_batch_iterator(dataset, config, tokenizer),
                      steps_per_epoch=len(dataset) // config.batch_size, device=device)
    # the Ref-YTVOS evaluator drives the trainer's model through the engine
    trainer.evaluate_fn = build_evaluator(config, tokenizer, trainer.model, val_dataset)
    result = None
    if running_mode == "train":
        trainer.train()
    elif running_mode == "resume_train":
        # reference main.py:26 resumes from the explicit checkpoint_path;
        # without one, from the latest epoch under output_dir
        trainer.load_checkpoint(path=config.get("checkpoint_path") or None)
        trainer.train()
    elif running_mode == "test":
        if trainer.evaluate_fn is None:
            raise SystemExit(f"no evaluator for dataset '{config.dataset_name}' "
                             "(is the valid split on disk?)")
        # reference main.py:29-35: -rm test loads checkpoint_path as the
        # model's weights (strict), not the trainer's history
        load_or_init(trainer, config)
        result = trainer.evaluate_fn(trainer.model, 0)
        print(result)
    elif running_mode == "pred":
        # reference main.py:36-43 and predict.py:25-97: the val split's best
        # masks drawn on its frames under <output_dir>/visualize
        if config.dataset_name not in ("a2d_sentences", "jhmdb_sentences"):
            raise SystemExit("-rm pred supports the a2d/jhmdb configs (the reference's "
                             "predict.py drives the A2D-style val loader)")
        from ..evaluators import run_predict_visualize

        val = val_dataset if val_dataset is not None else build_a2d_style_val_dataset(config)
        load_or_init(trainer, config)
        out_dir = (config.get("output_dir") or "outputs") + "/visualize"
        result = run_predict_visualize(
            trainer.model, val, tokenizer, out_dir, eval_batch_size=config.eval_batch_size,
            collate_kwargs=dict(size_buckets=_eval_size_buckets(config)))
        print(f"wrote {result} visualizations to {out_dir}")
    else:
        raise ValueError(f"use infer_refytb / infer_davis for {running_mode}")
    return trainer, result


def main(argv=None):
    parser = add_config_args(argparse.ArgumentParser("SOC training"), training=True)
    args = add_device_arg(parser).parse_args(argv)
    return run(config_from_args(args), args.running_mode, device=args.device)


if __name__ == "__main__":
    main()
