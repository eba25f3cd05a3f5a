"""Checkpoints with the reference trainer's retention policy (torch twin of
neurips2023_soc_tpu/training/checkpoint.py, on torch.save instead of orbax):
at most `max_keep` epoch checkpoints plus the best one, chosen by the
trainer. Each epoch is a directory `epoch_NNNN/` with `state.pt` (model and
optimizer state, step) and `meta.json`; `best.json` names the best epoch.

`save_reference_checkpoint` / `load_torch_checkpoint` read and write the
reference codebase's `.pth.tar` layout (weights under 'model_state_dict'
beside epoch/total_epochs/optimizer/scheduler/grad_scaler entries); the
port's state_dict keys are the reference's, so no conversion is needed.
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


def load_torch_checkpoint(path) -> Dict[str, torch.Tensor]:
    """The weights of a reference `.pth.tar` (or a bare state_dict) as a
    state_dict of CPU tensors."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return dict(ckpt.get("model_state_dict", ckpt.get("state_dict", ckpt)))


def save_reference_checkpoint(model: torch.nn.Module, path, epoch: int = 0,
                              total_epochs: int = 0, best_loss=None):
    """Write a `.pth.tar` in the reference trainer's on-disk layout, so a
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
    if best_loss is not None:
        ckpt["best_loss"] = float(best_loss)
    torch.save(ckpt, path)
    return path
