"""The ranks of tests/test_torch_ddp.py: the port's Trainer at the tiny
config on the CPU, in processes of a gloo group started by
torch.multiprocessing.spawn, and the same Trainer in one process as the
reference. Imports torch and the port only, so a spawned rank starts
quickly."""
import hashlib
from pathlib import Path

import torch
import torch.distributed as dist

from neurips2023_soc_torch.cli.main import make_batch_iterator
from neurips2023_soc_torch.config import load_config
from neurips2023_soc_torch.data import SyntheticRVOSDataset
from neurips2023_soc_torch.evaluators import build_a2d_evaluator
from neurips2023_soc_torch.models.common import Dropout
from neurips2023_soc_torch.models.text_encoder import build_tokenizer
from neurips2023_soc_torch.parallel import gather_objects, opt_state_bytes_per_rank
from neurips2023_soc_torch.training import Trainer

ROOT = Path(__file__).resolve().parents[1]
H, W, T = 64, 96, 1
SAMPLES, VAL_SAMPLES = 4, 3  # 2 global batches of 2 per epoch


def tiny_config(out_dir, **overrides):
    """configs/tiny_synthetic.yaml at 2 frames of 64 x 96 (one size bucket),
    a global batch of 2, no loader threads, seed 3."""
    return load_config(ROOT / "configs" / "tiny_synthetic.yaml", overrides={
        "output_dir": str(out_dir), "batch_size": 2, "window_size": T, "train_short_size": H,
        "train_max_size": W, "num_workers": 0, "seed": 3, "epochs": 1, **overrides})


def build_trainer(cfg) -> Trainer:
    """A Trainer over the synthetic clips, sharded by make_batch_iterator
    over the running group, with dropout and drop path off (the ranks draw
    their masks from other seeds than one process does)."""
    tok = build_tokenizer(cfg.text_encoder_type, cfg.text_bucket)
    ds = SyntheticRVOSDataset(num_samples=SAMPLES, num_frames=T, frame_size=(H, W), seed=0)
    trainer = Trainer(cfg, make_batch_iterator(ds, cfg, tok),
                      steps_per_epoch=SAMPLES // cfg.batch_size, device="cpu")
    for m in trainer.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
        if hasattr(m, "drop_path") and isinstance(m.drop_path, float):
            m.drop_path = 0.0
    return trainer


def a2d_evaluate(model, cfg) -> dict:
    """build_a2d_evaluator over 3 centre-frame synthetic clips: under a
    group each rank evaluates its share and the detections are gathered."""
    tok = build_tokenizer(cfg.text_encoder_type, cfg.text_bucket)
    val = SyntheticRVOSDataset(num_samples=VAL_SAMPLES, num_frames=T, frame_size=(H, W),
                               seed=1, center_frame_only=True)
    evaluate = build_a2d_evaluator(val, tok, eval_batch_size=1,
                                   collate_kwargs=dict(size_buckets=((H, W),),
                                                       time_buckets=(T,)))
    return evaluate(model, 0)


def weights(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _digests(model) -> dict:
    return {k: hashlib.sha1(v.detach().contiguous().numpy().tobytes()).hexdigest()
            for k, v in model.state_dict().items()}


def _same_on_every_rank(model, tag: str) -> None:
    digests = gather_objects(_digests(model))
    bad = [k for k in digests[0] if any(d[k] != digests[0][k] for d in digests[1:])]
    if bad:
        raise AssertionError(f"{tag}: parameters differ between ranks: {bad[:5]}")


def _state_bytes(trainer) -> dict:
    """AdamW's state if every rank held all of it (two float32 moments and a
    step count per trainable tensor), and the accumulator's bytes."""
    opt = trainer._state.optimizer
    return dict(adamw=sum(2 * p.numel() * 4 + 4 for p in opt.trainable),
                acc=sum(a.numel() * a.element_size() for a in opt.acc))


def ranks_main(rank: int, world: int, init_file: str, out_dir: str) -> None:
    """One rank: replicated training for an epoch of 2 steps and the A2D
    evaluator on its weights; ZeRO-1 with grad_accum_steps 2 for two epochs
    of one update each, and a resume of its epoch-0 checkpoint. Parameters
    are checked bit-equal across the ranks after each run; rank 0 saves
    what the test compares under out_dir/results.pt."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                            rank=rank)
    out = Path(out_dir)
    res = {}
    try:
        cfg = tiny_config(out / "replicated")
        trainer = build_trainer(cfg)
        trainer.train()
        _same_on_every_rank(trainer.model, "replicated")
        res["replicated"] = weights(trainer.model)
        res["replicated_losses"] = [h["loss"] for h in trainer.history]
        res["replicated_grad_norms"] = [h["grad_norm"] for h in trainer.history]
        res["eval"] = a2d_evaluate(trainer.model, cfg)

        cfg = tiny_config(out / "zero1", optimizer_sharding="zero1", grad_accum_steps=2,
                          epochs=2)
        trainer = build_trainer(cfg)
        trainer.train()
        _same_on_every_rank(trainer.model, "zero1")
        res["zero1"] = weights(trainer.model)
        res["zero1_count"] = trainer._state.optimizer.count
        res["zero1_bytes"] = gather_objects(opt_state_bytes_per_rank(trainer._state.optimizer))
        res["replicated_bytes"] = _state_bytes(trainer)
        resumed = build_trainer(cfg)
        resumed.load_checkpoint(epoch=0)
        resumed.train()
        _same_on_every_rank(resumed.model, "zero1 resumed")
        res["zero1_resumed"] = weights(resumed.model)
        if rank == 0:
            torch.save(res, out / "results.pt")
    finally:
        dist.destroy_process_group()
