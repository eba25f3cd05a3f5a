"""Checkpoints with the reference trainer's retention policy (torch twin of
neurips2023_soc_tpu/training/checkpoint.py, on torch.save instead of orbax):
at most `max_keep` epoch checkpoints plus the best one, chosen by the
trainer. Each epoch is a directory `epoch_NNNN/` with `state.pt` (model and
optimizer state, step) and `meta.json`; `best.json` names the best epoch.

`save_reference_checkpoint` / `load_torch_checkpoint` read and write the
reference codebase's `.pth.tar` layout (weights under 'model_state_dict'
beside epoch/total_epochs/optimizer/scheduler/grad_scaler entries); the
port's state_dict keys are the reference's, so no conversion is needed.
`load_pretrained` (the `-pw` warm start) and `load_params_from_path` (the
weights of `-ckpt` for `-rm test` / `pred`) load with a report of missing and
unused keys.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import torch


class CheckpointManager:
    def __init__(self, directory, max_keep: int = 5, create: bool = True):
        """`create=False` for read-only use: a mistyped path then fails with
        FileNotFoundError instead of leaving an empty tree behind."""
        self.dir = Path(directory)
        if create:
            self.dir.mkdir(parents=True, exist_ok=True)
        elif not self.dir.is_dir():
            raise FileNotFoundError(f"checkpoint directory not found: {self.dir}")
        self.max_keep = max_keep

    def _path(self, epoch: int) -> Path:
        return self.dir / f"epoch_{epoch:04d}"

    def save(self, epoch: int, state: Dict[str, Any], is_best: bool,
             extra: Optional[Dict[str, Any]] = None) -> Path:
        path = self._path(epoch)
        path.mkdir(parents=True, exist_ok=True)
        tmp = path / "state.pt.tmp"
        torch.save(state, tmp)
        tmp.replace(path / "state.pt")
        meta = {"epoch": epoch, **(extra or {})}
        (path / "meta.json").write_text(json.dumps(meta))
        if is_best:
            (self.dir / "best.json").write_text(json.dumps(meta))
        self._prune(self.best_epoch())
        return path

    def best_epoch(self) -> Optional[int]:
        bj = self.dir / "best.json"
        return json.loads(bj.read_text()).get("epoch") if bj.exists() else None

    def _prune(self, best_epoch: Optional[int]) -> None:
        ckpts = sorted(self.dir.glob("epoch_*"))
        removable = [c for c in ckpts
                     if best_epoch is None or c.name != f"epoch_{best_epoch:04d}"]
        while len(ckpts) > self.max_keep and removable:
            victim = removable.pop(0)
            ckpts.remove(victim)
            shutil.rmtree(victim)

    def latest_epoch(self) -> Optional[int]:
        ckpts = sorted(self.dir.glob("epoch_*"))
        return int(ckpts[-1].name.split("_")[1]) if ckpts else None

    def restore(self, epoch: int, map_location=None) -> Dict[str, Any]:
        return torch.load(self._path(epoch) / "state.pt", map_location=map_location,
                          weights_only=True)

    def read_meta(self, epoch: int) -> Optional[Dict[str, Any]]:
        mj = self._path(epoch) / "meta.json"
        return json.loads(mj.read_text()) if mj.exists() else None


def load_torch_checkpoint(path, loaded_ckpt=None) -> Dict[str, torch.Tensor]:
    """The weights of a reference `.pth.tar` (or a bare state_dict) as a
    state_dict of CPU tensors. `loaded_ckpt` is the file already read by the
    caller (for its epoch and best metadata), so it is not read twice."""
    ckpt = loaded_ckpt
    if ckpt is None:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return dict(ckpt.get("model_state_dict", ckpt.get("state_dict", ckpt)))


def save_reference_checkpoint(model: torch.nn.Module, path, epoch: int = 0,
                              total_epochs: int = 0, best_map=None, best_loss=None):
    """Write a `.pth.tar` in the reference trainer's on-disk layout
    (trainer.py:380-422: the weights under 'model_state_dict' beside
    epoch/total_epochs/optimizer/scheduler/grad_scaler entries, best_mAP for
    A2D-style runs or best_loss for Ref-YouTube-VOS-style ones), so a
    checkpoint trained here loads in the reference codebase and its
    inference tools."""
    ckpt = {
        "epoch": epoch,
        "total_epochs": total_epochs,
        "model_state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer_state_dict": {},
        "scheduler_state_dict": {},
        "grad_scaler_state_dict": {},
    }
    if best_map is not None:
        ckpt["best_mAP"] = float(best_map)
    if best_loss is not None:
        ckpt["best_loss"] = float(best_loss)
    torch.save(ckpt, path)
    return path


def _reference_state_dict(path, drop_class_embed: bool, loaded_ckpt):
    sd = load_torch_checkpoint(path, loaded_ckpt=loaded_ckpt)
    if drop_class_embed:  # the reference's pretrain -> finetune surgery (trainer.py:430-438)
        sd = {k: v for k, v in sd.items() if not k.startswith("class_embed")}
    return sd


def _load_with_report(model: torch.nn.Module, sd: Dict[str, torch.Tensor], source,
                      mismatched_missing: bool, strict: bool) -> Dict[str, list]:
    """Copy `sd` into `model` and return {'missing': model keys it does not
    fill, 'unused': its keys the model lacks}; the missing keep the model's
    values. With `mismatched_missing` a tensor saved with another shape counts
    as missing (else loading it raises); `strict` raises on any missing or
    unused key before the model is touched."""
    own = model.state_dict()
    missing = sorted(k for k in own if k not in sd or (
        mismatched_missing and tuple(sd[k].shape) != tuple(own[k].shape)))
    unused = sorted(k for k in sd if k not in own)
    report = {"missing": missing, "unused": unused}
    if strict and (missing or unused):
        detail = "; ".join(
            f"{kind}: " + ", ".join(report[kind][:20]) + (" ..." if len(report[kind]) > 20 else "")
            for kind in ("missing", "unused") if report[kind])
        raise ValueError(f"loaded {source}: {len(missing)} missing, {len(unused)} unused "
                         f"keys; {detail}")
    skip = set(missing) | set(unused)
    model.load_state_dict({k: v for k, v in sd.items() if k not in skip}, strict=False)
    return report


def load_pretrained(model: torch.nn.Module, path, drop_class_embed: bool = False,
                    loaded_ckpt=None) -> Dict[str, list]:
    """A reference `.pth.tar` into `model`, the `-pw` warm start (the
    counterpart of the JAX package's load_pretrained_into_params): returns
    {'missing', 'unused'}. `drop_class_embed` leaves the class heads at the
    model's values."""
    sd = _reference_state_dict(path, drop_class_embed, loaded_ckpt)
    return _load_with_report(model, sd, path, mismatched_missing=False, strict=False)


def _epoch_state_dict(path: Path) -> Dict[str, torch.Tensor]:
    """The model weights of an `epoch_NNNN` directory, or of the best (else
    the latest) epoch under a CheckpointManager root."""
    if not path.is_dir():
        raise FileNotFoundError(f"checkpoint path not found: {path}")
    if path.name.startswith("epoch_"):
        mgr, epoch = CheckpointManager(path.parent, create=False), int(path.name.split("_")[1])
    else:
        mgr = CheckpointManager(path, create=False)
        epoch = mgr.best_epoch()
        epoch = epoch if epoch is not None else mgr.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no epoch checkpoint under {path}")
    return mgr.restore(epoch, map_location="cpu")["model"]


def load_params_from_path(model: torch.nn.Module, path, drop_class_embed: bool = False,
                          loaded_ckpt=None, strict: bool = False) -> Dict[str, list]:
    """Model weights from an explicit checkpoint path (reference main.py:29-35
    loads config.checkpoint_path): a reference `.pth`/`.pth.tar`/`.pt`, an
    `epoch_NNNN` directory of CheckpointManager, or its root (the best epoch,
    else the latest). Returns {'missing', 'unused'}; from a directory, a
    tensor saved with another shape counts as missing and keeps the model's
    value, never a wrong tensor. `strict` raises on any missing or unused key
    before the model is touched."""
    p = str(path)
    if p.endswith((".pth", ".pth.tar", ".pt")):
        sd = _reference_state_dict(p, drop_class_embed, loaded_ckpt)
        return _load_with_report(model, sd, p, mismatched_missing=False, strict=strict)
    return _load_with_report(model, _epoch_state_dict(Path(p)), p, mismatched_missing=True,
                             strict=strict)
