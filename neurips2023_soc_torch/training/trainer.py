"""Trainer (torch twin of neurips2023_soc_tpu/training/trainer.py), on one
card or on several ranks of a torch.distributed process group.

Behaviour kept from the reference trainer: 3 lr groups with MultiStepLR
(gamma 0.2 for A2D, 0.1 otherwise) counted in updates, grad accumulation,
abort on a non-finite loss, an evaluation hook every epoch (its metrics go
into `log.txt` as `eval_<metric>`), the best checkpoint by mAP for A2D (by the
mean mask mAP when pretraining with val sets, else by the lowest train loss),
at most 5 epoch checkpoints (10 when pretraining) plus the best, resume, the
`pretrained_weights` warm start, strict weight loading for `-rm test` /
`pred`, a torch.profiler trace of steps 1..`profile_steps` of the first
epoch, a JSON-lines `log.txt` per epoch and, with `wandb_mode: online`, the
same records to wandb (imported only then). The loss is read on the host
every step (the abort check), as in JAX.

Several ranks (the JAX package's data mesh, parallel/mesh.py): when a
process group runs, the model is wrapped in DistributedDataParallel, each
rank takes `batch_size / world` samples of every global batch
(cli/main.py:make_batch_iterator), and the step is one global step
(training/train_step.py). `optimizer_sharding: zero1` shards AdamW's state
(parallel/zero.py). The frozen text encoder's parameters are set to need no
gradient, so DDP reduces exactly the tensors the loss reaches (every other
parameter gets a gradient in each step). Dropout and drop path draw from the
step's seed plus the rank. Rank 0 alone writes `log.txt`, checkpoints,
`best.json` and to wandb; the others wait at a barrier after each save, and
every rank reads a checkpoint to resume.
"""
from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Union

import torch

from ..device import resolve_device
from ..losses import build_criterion_config
from ..models import build_model
from ..parallel.multihost import barrier, distributed, is_main_process, process_index_and_count
from ..utils.logging import MetricLogger, SmoothedValue, profile_trace
from ..utils.prefetch import prefetch
from .checkpoint import CheckpointManager, load_params_from_path, load_pretrained
from .optim import build_optimizer, update_milestones_from_microsteps
from .train_step import TrainState, make_train_step


def check_batch_divides(batch_size: int, world: int) -> None:
    """The global batch must divide over the ranks (the JAX trainer's check
    of its devices, with its message). JAX's `allow_idle_devices` shrinks
    the mesh instead; DDP needs every rank in each step's all-reduce, so the
    port cannot leave a rank idle and raises in either case."""
    if batch_size % world == 0:
        return
    n = max(d for d in range(1, world + 1) if batch_size % d == 0)
    raise ValueError(
        f"batch_size={batch_size} is not divisible by the {world} "
        f"available devices — training would use {n} device(s) "
        f"and leave {world - n} idle. Raise batch_size to a "
        f"multiple of {world}, or launch {n} ranks (a DDP rank cannot be left idle, "
        "so allow_idle_devices does not apply here).")


class Trainer:
    def __init__(self, config, train_batches: Callable[[int], Iterable[Dict]],
                 steps_per_epoch: int, evaluate_fn: Optional[Callable] = None,
                 device: Optional[Union[str, torch.device]] = None):
        """train_batches(epoch) yields host batch dicts (data/collate.py),
        this rank's share under a process group; evaluate_fn(model, epoch)
        -> metrics dict, run after every epoch (the evaluators of
        evaluators.py); `device` None means the CUDA card (the rank's own
        under a process group)."""
        self.config = config
        self.rank, self.world = process_index_and_count()
        check_batch_divides(int(config.batch_size), self.world)
        self.local_batch = int(config.batch_size) // self.world
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.model = build_model(config, device=self.device, seed=int(config.seed))
        self.crit_cfg = build_criterion_config(config)
        self.train_batches = train_batches
        self.steps_per_epoch = steps_per_epoch
        self.evaluate_fn = evaluate_fn

        self.dataset_name = config.dataset_name
        self._is_pretrain = self.dataset_name in ("coco", "coco_refer")
        self.total_epochs = config.epochs
        self.epoch = 0
        self.best_map = 0.0
        self.best_loss = math.inf
        # per step of the last train() call: loss, every loss term,
        # grad_norm, step and data time (host clock)
        self.history: List[Dict[str, float]] = []

        self.output_dir = Path(config.get("output_dir") or f"outputs/{self.dataset_name}")
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.ckpt = CheckpointManager(self.output_dir / "checkpoints",
                                      max_keep=10 if self._is_pretrain else 5)
        self.gamma = 0.2 if self.dataset_name == "a2d_sentences" else 0.1
        self.milestones_steps = [int(m) * steps_per_epoch
                                 for m in (config.get("lr_drop", []) or [])]
        self._state: Optional[TrainState] = None
        self._train_step = None
        self._zero1 = str(config.get("optimizer_sharding", "replicated")).lower() == "zero1"
        # optional wandb (reference trainer.py:113-114), rank 0 only; the
        # package is imported only when asked for
        self._wandb = None
        if config.get("wandb_mode") == "online" and is_main_process():
            try:
                import wandb

                wandb.init(project="RefVOS", config=config.to_dict(), name="SOC_torch")
                self._wandb = wandb
            except ImportError:
                print("wandb requested but not installed; logging to log.txt only")

    def init_state(self) -> TrainState:
        """The optimizer and train step, after the `pretrained_weights` warm
        start (JAX trainer.py:125-131) when the config names one."""
        cfg = self.config
        if cfg.get("pretrained_weights"):
            report = load_pretrained(self.model, cfg.pretrained_weights,
                                     drop_class_embed=bool(cfg.get("drop_class_embed", False)))
            print(f"loaded pretrained weights: {len(report['missing'])} missing, "
                  f"{len(report['unused'])} unused")
        accum = int(cfg.get("grad_accum_steps", 1) or 1)
        optimizer = build_optimizer(
            self.model, lr=float(cfg.lr), lr_backbone=float(cfg.lr_backbone),
            text_encoder_lr=float(cfg.text_encoder_lr),
            weight_decay=float(cfg.weight_decay), clip_max_norm=float(cfg.clip_max_norm),
            milestones_steps=update_milestones_from_microsteps(self.milestones_steps, accum),
            gamma=self.gamma, freeze_text=bool(cfg.freeze_text_encoder),
            grad_accum_steps=accum, zero1=self._zero1)
        self._state = TrainState(self._ddp_model(), optimizer)
        has_valid = self.dataset_name in ("a2d_sentences", "jhmdb_sentences")
        self._train_step = make_train_step(self._state.model, self.crit_cfg,
                                           has_valid_indices=has_valid)
        return self._state

    def _ddp_model(self) -> torch.nn.Module:
        """The module the train step calls: the model itself in a single
        process, its DistributedDataParallel wrapper under a process group
        (which broadcasts rank 0's parameters to every rank)."""
        if not distributed():
            return self.model
        if self.config.freeze_text_encoder:
            self.model.text_encoder.requires_grad_(False)
        from torch.nn.parallel import DistributedDataParallel

        ids = [self.device.index] if self.device.type == "cuda" else None
        return DistributedDataParallel(self.model, device_ids=ids)

    def train(self) -> None:
        """Setting config.profile_steps = N wraps steps 1..N of the first
        epoch in a torch.profiler trace written under output_dir/profile."""
        print("Training started...")
        if self._state is None:
            self.init_state()
        self.history = []
        seed = int(self.config.seed) + 1
        profile_steps = int(self.config.get("profile_steps", 0) or 0)
        for self.epoch in range(self.epoch, self.total_epochs):
            prof = None
            t_epoch = time.time()
            epoch_loss, n = 0.0, 0
            mlog = MetricLogger()
            iter_time = SmoothedValue(fmt="{avg:.4f}")
            data_time = SmoothedValue(fmt="{avg:.4f}")
            end = time.perf_counter()
            for i, batch in enumerate(prefetch(self.train_batches(self.epoch))):
                data_time.update(time.perf_counter() - end)
                if profile_steps and self.epoch == 0 and i == 1:
                    prof = profile_trace(str(self.output_dir / "profile"))
                    prof.__enter__()
                if distributed() and batch["pixels"].shape[1] != self.local_batch:
                    # the criterion's loss_con is a local mean: equal local
                    # batches make its mean over ranks the global mean
                    raise ValueError(f"rank {self.rank}: a local batch of "
                                     f"{batch['pixels'].shape[1]}, expected {self.local_batch}")
                step_seed = seed * 1_000_003 + self._state.step + self.rank
                self._state, metrics = self._train_step(self._state, batch, step_seed)
                loss = float(metrics["loss"])  # host read: the abort check
                if not math.isfinite(loss):
                    raise FloatingPointError(f"Loss is {loss}, stopping training")
                if prof is not None and i == profile_steps:
                    prof.__exit__(None, None, None)
                    prof = None
                epoch_loss += loss
                n += 1
                terms = {k: v for k, v in metrics.items() if k != "loss"}
                terms = dict(zip(terms, torch.stack(list(terms.values())).tolist()))
                mlog.update(loss=loss, grad_norm=terms["grad_norm"], lr=self._state.optimizer.lr("main"))
                dt = time.perf_counter() - end
                iter_time.update(dt)
                self.history.append({"loss": loss, **terms, "step_time_s": dt,
                                     "data_time_s": data_time.value})
                if i % 10 == 0:
                    eta = int(iter_time.avg * max(self.steps_per_epoch - i, 0))
                    print(f"Epoch: [{self.epoch}] [{i}/{self.steps_per_epoch}] eta: {eta}s "
                          f"{mlog} time: {iter_time} data: {data_time}", flush=True)
                end = time.perf_counter()
            if prof is not None:  # an epoch shorter than profile_steps
                prof.__exit__(None, None, None)

            log_stats = {
                "epoch": self.epoch,
                "train_loss": epoch_loss / max(n, 1),
                "epoch_time_s": time.time() - t_epoch,
                "step_time_s": iter_time.global_avg,
                "data_time_s": data_time.global_avg,
                "lr": self._state.optimizer.lr("main"),
            }
            eval_metrics = {}
            if self.evaluate_fn is not None:
                eval_metrics = self.evaluate_fn(self.model, self.epoch)
                log_stats.update({f"eval_{k}": v for k, v in eval_metrics.items()})
            is_best = self._update_best(eval_metrics, epoch_loss)
            self.save_checkpoint(is_best, log_stats)
            if is_main_process():
                with open(self.output_dir / "log.txt", "a") as f:
                    f.write(json.dumps(log_stats) + "\n")
                if self._wandb is not None:
                    self._wandb.log(log_stats)

    def _update_best(self, eval_metrics: Dict, epoch_loss: float) -> bool:
        """Best by `mAP 0.5:0.95` for A2D, by `mean_mask_mAP` when pretraining
        with val sets (reference pretrainer.py:234-238), else by the lowest
        train loss (JAX training/trainer.py:_update_best)."""
        key = None
        if self.dataset_name == "a2d_sentences":
            key = "mAP 0.5:0.95"
        elif self._is_pretrain and "mean_mask_mAP" in eval_metrics:
            key = "mean_mask_mAP"
        if key is not None:
            m = eval_metrics.get(key, 0.0) or 0.0
            if m > self.best_map:
                self.best_map = m
                return True
            return False
        if epoch_loss < self.best_loss:
            self.best_loss = epoch_loss
            return True
        return False

    def save_checkpoint(self, is_best: bool, extra: Dict) -> Optional[Path]:
        """Every rank calls it (the ZeRO-1 state is gathered to rank 0);
        rank 0 writes, then all wait for it. Returns the checkpoint's path
        on rank 0, None on the others."""
        optimizer = self._state.optimizer.state_dict()
        path = None
        if is_main_process():
            state = {"model": self.model.state_dict(), "optimizer": optimizer,
                     "step": self._state.step}
            extra = {k: v for k, v in extra.items() if isinstance(v, (int, float, str))}
            extra["best_map"] = float(self.best_map)
            extra["best_loss"] = float(self.best_loss)
            path = self.ckpt.save(self.epoch, state, is_best, extra=extra)
        barrier("checkpoint")
        return path

    def load_weights(self, path, strict: bool = True, _loaded_ckpt=None) -> None:
        """Model weights from an explicit checkpoint path (a reference
        `.pth.tar`, an `epoch_NNNN` directory or a checkpoints root) for
        `-rm test` / `pred` (reference main.py:28-43 loads
        config.checkpoint_path with load_state_dict(strict=True)); the
        optimizer is untouched. `strict` raises on a missing or an unexpected
        key, before the model changes; strict=False loads what matches and
        prints the counts, as the reference's inference CLIs do."""
        report = load_params_from_path(self.model, path, loaded_ckpt=_loaded_ckpt,
                                       strict=strict)
        if report["missing"] or report["unused"]:
            print(f"loaded {path}: {len(report['missing'])} missing, "
                  f"{len(report['unused'])} unused keys")

    def load_checkpoint(self, epoch: Optional[int] = None, path=None) -> None:
        """Resume from an epoch checkpoint: model, optimizer, step and best
        tracking (the latest under output_dir by default; `path` names an
        `epoch_NNNN` directory or a checkpoints root). Training resumes at
        the next epoch. A reference `.pth.tar` as `path` gives the weights
        and the epoch, total epochs (when the config sets none) and best
        values it carries; its optimizer state is not read, so the optimizer
        and schedule restart, as in JAX."""
        if self._state is None:
            self.init_state()
        if path is not None and str(path).endswith((".pth", ".pth.tar", ".pt")):
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
            self.load_weights(path, _loaded_ckpt=ckpt)
            self.epoch = int(ckpt.get("epoch", -1)) + 1
            if "total_epochs" in ckpt and self.config.get("epochs") is None:
                self.total_epochs = int(ckpt["total_epochs"])
            if "best_mAP" in ckpt:
                self.best_map = float(ckpt["best_mAP"])
            if "best_loss" in ckpt:
                self.best_loss = float(ckpt["best_loss"])
            print("resumed weights from a reference checkpoint; the optimizer and "
                  "schedule restart")
            return
        source = self.ckpt
        if path is not None:
            p = Path(path)
            if p.name.startswith("epoch_"):
                source = CheckpointManager(p.parent, max_keep=self.ckpt.max_keep,
                                           create=False)
                epoch = int(p.name.split("_")[1])
            else:
                source = CheckpointManager(p, max_keep=self.ckpt.max_keep, create=False)
        epoch = epoch if epoch is not None else source.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint under {source.dir}")
        state = source.restore(epoch, map_location=self.device)
        self.model.load_state_dict(state["model"])
        self._state.optimizer.load_state_dict(state["optimizer"])
        self._state.step = int(state["step"])
        self.epoch = epoch + 1
        meta = source.read_meta(epoch)
        if meta:
            self.best_map = float(meta.get("best_map", self.best_map))
            self.best_loss = float(meta.get("best_loss", self.best_loss))
