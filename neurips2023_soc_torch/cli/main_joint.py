"""Joint RefCOCO-as-clip + Ref-YouTube-VOS training (reference main_joint.py
and jointtrainer.py), on the CUDA card:

    python -m neurips2023_soc_torch.cli.main_joint -c configs/joint.yaml --coco_folder data/coco

Both sources are concatenated (RefCOCO images as 8-frame pseudo-videos);
each epoch evaluates on Ref-YouTube-VOS only, when its valid split is on
disk. Modes `train` and `resume_train`; `--device cpu` runs on the CPU.
"""
from __future__ import annotations

import argparse

from ..config import add_config_args, config_from_args
from ..data.coco_ref import ConcatClipDataset
from ..device import resolve_device
from ..models.text_encoder import build_tokenizer
from ..parallel import initialize_distributed
from ..training.trainer import Trainer
from .infer_refytb import add_device_arg
from .main import build_train_dataset, build_ytvos_evaluator_if_on_disk, make_batch_iterator
from .main_pretrain import build_pretrain_dataset


def run(config, running_mode: str, coco_folder: str, device=None) -> Trainer:
    """main() after parsing; `device` None is the CUDA card."""
    device = resolve_device(device)
    initialize_distributed(config)
    ytvos = build_train_dataset(config.replace(dataset_name="ref_youtube_vos"))
    # the 8-frame image-as-clip pipeline (reference ref2seq.py), unlike the
    # single-frame pretrainer
    coco = build_pretrain_dataset(config.replace(img_folder=coco_folder), as_clip=True)
    dataset = ConcatClipDataset([coco, ytvos])
    tokenizer = build_tokenizer(config.text_encoder_type, config.get("text_bucket", 32))
    trainer = Trainer(config, train_batches=make_batch_iterator(dataset, config, tokenizer),
                      steps_per_epoch=len(dataset) // config.batch_size, device=device)
    # the joint trainer evaluates on Ref-YTVOS only (reference jointtrainer.py
    # evaluate_refer_youtube_vos)
    trainer.evaluate_fn = build_ytvos_evaluator_if_on_disk(config, trainer.model)
    if running_mode == "resume_train":
        trainer.load_checkpoint(path=config.get("checkpoint_path") or None)
    elif running_mode != "train":
        raise ValueError(f"main_joint runs train or resume_train, not {running_mode}")
    trainer.train()
    return trainer


def main(argv=None):
    parser = add_config_args(argparse.ArgumentParser("SOC joint training"), training=True)
    parser.add_argument("--coco_folder", default="data/coco")
    args = add_device_arg(parser).parse_args(argv)
    return run(config_from_args(args), args.running_mode, args.coco_folder, device=args.device)


if __name__ == "__main__":
    main()
