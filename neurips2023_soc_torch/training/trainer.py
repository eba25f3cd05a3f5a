"""Single-card trainer (torch twin of neurips2023_soc_tpu/training/trainer.py,
without its mesh, ZeRO-1 and wandb).

Behaviour kept from the reference trainer: 3 lr groups with MultiStepLR
(gamma 0.2 for A2D, 0.1 otherwise) counted in updates, grad accumulation,
abort on a non-finite loss, an evaluation hook every epoch (its metrics go
into `log.txt` as `eval_<metric>`), the best checkpoint by mAP for A2D (by the
mean mask mAP when pretraining with val sets, else by the lowest train loss),
at most 5 epoch checkpoints (10 when pretraining) plus the best, resume, and
a JSON-lines `log.txt` per epoch. The loss is read on the host every step
(the abort check), as in JAX.
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
from ..utils.logging import MetricLogger, SmoothedValue
from ..utils.prefetch import prefetch
from .checkpoint import CheckpointManager
from .optim import build_optimizer, update_milestones_from_microsteps
from .train_step import TrainState, make_train_step


class Trainer:
    def __init__(self, config, train_batches: Callable[[int], Iterable[Dict]],
                 steps_per_epoch: int, evaluate_fn: Optional[Callable] = None,
                 device: Optional[Union[str, torch.device]] = None):
        """train_batches(epoch) yields host batch dicts (data/collate.py);
        evaluate_fn(model, epoch) -> metrics dict, run after every epoch (the
        evaluators of evaluators.py); `device` None means the CUDA card."""
        self.config = config
        self.device = resolve_device(device)
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

    def init_state(self) -> TrainState:
        cfg = self.config
        accum = int(cfg.get("grad_accum_steps", 1) or 1)
        optimizer = build_optimizer(
            self.model, lr=float(cfg.lr), lr_backbone=float(cfg.lr_backbone),
            text_encoder_lr=float(cfg.text_encoder_lr),
            weight_decay=float(cfg.weight_decay), clip_max_norm=float(cfg.clip_max_norm),
            milestones_steps=update_milestones_from_microsteps(self.milestones_steps, accum),
            gamma=self.gamma, freeze_text=bool(cfg.freeze_text_encoder),
            grad_accum_steps=accum)
        self._state = TrainState(self.model, optimizer)
        has_valid = self.dataset_name in ("a2d_sentences", "jhmdb_sentences")
        self._train_step = make_train_step(self.model, self.crit_cfg,
                                           has_valid_indices=has_valid)
        return self._state

    def train(self) -> None:
        print("Training started...")
        if self._state is None:
            self.init_state()
        self.history = []
        seed = int(self.config.seed) + 1
        for self.epoch in range(self.epoch, self.total_epochs):
            t_epoch = time.time()
            epoch_loss, n = 0.0, 0
            mlog = MetricLogger()
            iter_time = SmoothedValue(fmt="{avg:.4f}")
            data_time = SmoothedValue(fmt="{avg:.4f}")
            end = time.perf_counter()
            for i, batch in enumerate(prefetch(self.train_batches(self.epoch))):
                data_time.update(time.perf_counter() - end)
                step_seed = seed * 1_000_003 + self._state.step
                self._state, metrics = self._train_step(self._state, batch, step_seed)
                loss = float(metrics["loss"])  # host read: the abort check
                if not math.isfinite(loss):
                    raise FloatingPointError(f"Loss is {loss}, stopping training")
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
            with open(self.output_dir / "log.txt", "a") as f:
                f.write(json.dumps(log_stats) + "\n")

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

    def save_checkpoint(self, is_best: bool, extra: Dict) -> Path:
        state = {"model": self.model.state_dict(),
                 "optimizer": self._state.optimizer.state_dict(),
                 "step": self._state.step}
        extra = {k: v for k, v in extra.items() if isinstance(v, (int, float, str))}
        extra["best_map"] = float(self.best_map)
        extra["best_loss"] = float(self.best_loss)
        return self.ckpt.save(self.epoch, state, is_best, extra=extra)

    def load_checkpoint(self, epoch: Optional[int] = None, path=None) -> None:
        """Resume model, optimizer, step and best tracking from an epoch
        checkpoint (the latest under output_dir by default; `path` names an
        `epoch_NNNN` directory or a checkpoints root). Training resumes at
        the next epoch."""
        if self._state is None:
            self.init_state()
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
