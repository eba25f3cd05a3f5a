"""Multi-rank training of the port on the CPU: two ranks of a gloo group
(torch.multiprocessing.spawn, `init_method=file://` under tmp_path, one
torch thread each; tests/torch_ddp_worker.py) against the port's own
Trainer in one process on the same global batches. The one-process step is
held against JAX by tests/test_torch_train_step.py. Dropout and drop path
are off on both sides. Checked: the 2-rank step equals the 1-process step
at 1e-4 of each tensor's scale for `optimizer_sharding: replicated` and for
`zero1` with grad_accum_steps 2; the ranks' parameters are bit-equal after
every run; each rank holds at most 0.6 of the replicated AdamW state under
ZeRO-1; a ZeRO-1 checkpoint resumes to the same next epoch; only rank 0
writes log.txt and checkpoints; the A2D evaluator gathers the ranks'
shares into the 1-process metrics. In process: the
criterion on two shards of a batch, `num_masks` summed over them, against
JAX's compute_criterion on the whole batch at 1e-5."""
import json
import shutil

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_ddp_worker as worker
from neurips2023_soc_tpu import losses as jl
from neurips2023_soc_torch import losses as tl
from neurips2023_soc_torch.losses import criterion as torch_criterion
from neurips2023_soc_torch.parallel import multihost
from neurips2023_soc_torch.training.trainer import check_batch_divides
from test_torch_losses import _configs, _outputs_targets, _torch
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)


def _close(got: dict, want: dict, keys=None) -> None:
    """Every tensor within 1e-4 of its scale (max(1, max |want|))."""
    for k in keys or want:
        w = want[k].float().numpy()
        np.testing.assert_allclose(got[k].float().numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(np.abs(w).max())), err_msg=k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results (tests/torch_ddp_worker.py:ranks_main), what
    they left on disk (log.txt, the checkpoint directories, two
    checkpoints), and, computed while they run, the reference: the same
    Trainer in one process, replicated for one epoch (2 steps) and with
    grad_accum_steps 2 (one update). The checkpoints (a third of a GB each)
    are deleted once read."""
    out = tmp_path_factory.mktemp("ddp")
    ranks = mp.spawn(worker.ranks_main, args=(2, str(out / "init"), str(out)), nprocs=2,
                     join=False)
    try:
        cfg = worker.tiny_config(out / "single")
        trainer = worker.build_trainer(cfg)
        trainer.train()
        accum = worker.build_trainer(worker.tiny_config(out / "single_accum", grad_accum_steps=2))
        accum.train()
        ref = dict(replicated=worker.weights(trainer.model),
                   losses=[h["loss"] for h in trainer.history],
                   grad_norms=[h["grad_norm"] for h in trainer.history],
                   accum=worker.weights(accum.model),
                   eval=worker.a2d_evaluate(trainer.model, cfg))
    finally:
        while not ranks.join():
            pass
    res = torch.load(out / "results.pt", weights_only=False)
    ckpts = out / "zero1" / "checkpoints"
    res["epoch0"] = torch.load(ckpts / "epoch_0000" / "state.pt", weights_only=False)
    res["epoch1_optimizer"] = torch.load(ckpts / "epoch_0001" / "state.pt",
                                         weights_only=False)["optimizer"]
    res["files"] = {run: ([json.loads(r)["epoch"] for r in
                           (out / run / "log.txt").read_text().splitlines()],
                          sorted(p.name for p in (out / run / "checkpoints").glob("epoch_*")))
                    for run in ("replicated", "zero1")}
    shutil.rmtree(out)
    return res, ref


def test_two_ranks_step_equals_one_process(runs, tmp_path):
    """replicated after an epoch of 2 steps, and ZeRO-1 with
    grad_accum_steps 2 after its first update (its epoch-0 checkpoint); the
    rank-averaged losses and the gradient norms (the scale of the ranks'
    mean, which the clip and AdamW's first steps hide in the parameters)
    equal the 1-process ones; the frozen text encoder stays put."""
    res, one_process = runs
    _close(res["replicated"], one_process["replicated"])
    np.testing.assert_allclose(res["replicated_losses"], one_process["losses"], rtol=1e-5)
    np.testing.assert_allclose(res["replicated_grad_norms"], one_process["grad_norms"],
                               rtol=1e-5)
    epoch0 = res["epoch0"]
    assert epoch0["optimizer"]["count"] == 1 and res["zero1_count"] == 2
    _close(epoch0["model"], one_process["accum"])
    init = worker.build_trainer(worker.tiny_config(tmp_path)).model.state_dict()
    moved = {k for k, v in res["replicated"].items() if not torch.equal(v, init[k])}
    assert not any(k.startswith("text_encoder.") for k in moved)
    assert any(k.startswith("backbone.") for k in moved) and "query_embed.weight" in moved


def test_zero1_state_is_sharded_and_resumes(runs):
    """Each rank holds at most 0.6 of the replicated AdamW state (beside
    the accumulator, whole on every rank), the checkpoint holds the whole
    of it, and the resume of epoch 0's checkpoint reproduces epoch 1 bit
    for bit."""
    res, _ = runs
    full = res["replicated_bytes"]
    assert all(full["acc"] < b <= 0.6 * full["adamw"] + full["acc"] for b in res["zero1_bytes"])
    stored = sum(v.numel() * v.element_size()
                 for s in res["epoch1_optimizer"]["adamw"]["state"].values()
                 for v in s.values() if torch.is_tensor(v))
    assert stored == full["adamw"]
    for k, v in res["zero1"].items():
        assert torch.equal(res["zero1_resumed"][k], v), k


def test_rank0_writes_and_gathered_evaluation(runs, tmp_path):
    """One log.txt line per epoch (rank 0 alone writes; the resumed run
    appends epoch 1 again), the checkpoints of rank 0 only, and the A2D
    metrics of the gathered shares equal to one process evaluating the
    same weights."""
    res, one_process = runs
    assert res["files"] == {"replicated": ([0], ["epoch_0000"]),
                            "zero1": ([0, 1, 1], ["epoch_0000", "epoch_0001"])}
    model = worker.build_trainer(worker.tiny_config(tmp_path)).model
    model.load_state_dict(res["replicated"])
    assert res["eval"] == worker.a2d_evaluate(model, worker.tiny_config(tmp_path))
    assert set(res["eval"]) == set(one_process["eval"])


def test_batch_must_divide_over_ranks():
    check_batch_divides(8, 4)
    with pytest.raises(ValueError, match="batch_size=6 is not divisible by the 4"):
        check_batch_divides(6, 4)


def _shard(d: dict, lo: int, hi: int) -> dict:
    """Samples lo:hi of SOC outputs or collated targets (batch on axis 2 of
    the stacked per-frame outputs, 1 of pred_logit and the per-frame
    targets, 0 of the rest)."""
    axis = {"pred_masks": 2, "pred_cls": 2, "pred_boxes": 2, "pred_logit": 1,
            "masks": 1, "boxes": 1, "is_ref_inst_visible": 1}
    return {k: np.take(v, np.arange(lo, hi), axis=axis.get(k, 0)) for k, v in d.items()}


@pytest.mark.parametrize("empty_shard", [False, True])
def test_criterion_on_two_shards_vs_jax_whole_batch(monkeypatch, empty_shard):
    """The batch of 4 split into two ranks' shards of 2: with `num_masks`
    summed over the shards (the all-reduce) and divided by 2, the mean of
    the shards' loss terms is JAX's on the whole batch. The shards hold
    different counts of valid instances; in one case a shard holds none."""
    out, tgt = _outputs_targets(5, B=4, N=3)
    tgt["inst_valid"][2, 1:] = False
    if empty_shard:
        tgt["inst_valid"][2:] = False
        tgt["referred_instance_idx"][2:] = 0
    jcfg, tcfg = _configs(1)
    want = jax.jit(jl.compute_criterion, static_argnums=2)(out, tgt, jcfg)
    shards = [(_shard(out, 0, 2), _shard(tgt, 0, 2)), (_shard(out, 2, 4), _shard(tgt, 2, 4))]
    T = out["pred_cls"].shape[1]
    total = sum(T * float(t["inst_valid"].sum()) for _, t in shards)
    monkeypatch.setattr(torch_criterion, "all_reduce_sum", lambda x: torch.tensor(total))
    monkeypatch.setattr(torch_criterion, "world_size", lambda: 2)
    got = [tl.compute_criterion(_torch(o), _torch(t), tcfg) for o, t in shards]
    assert sorted(got[0]) == sorted(want)
    for k in want:
        mean = (got[0][k] + got[1][k]).item() / 2
        np.testing.assert_allclose(mean, float(want[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(
        sum(tl.total_loss(g, tcfg).item() for g in got) / 2,
        float(jl.total_loss(want, jcfg)), rtol=1e-5, atol=1e-5)


def test_helpers_in_one_process(monkeypatch):
    """Without a group the all-reduces and gathers are the identity and the
    world is 1; the backend is DIST_BACKEND's, else the config's, else
    gloo on a machine without CUDA, and an unknown one is refused."""
    x = torch.tensor([1.5, 2.0])
    assert multihost.all_reduce_sum(x) is x and multihost.all_reduce_mean(x) is x
    assert multihost.world_size() == 1 and multihost.gather_objects(3) == [3]
    monkeypatch.delenv("DIST_BACKEND", raising=False)
    cfg = worker.tiny_config("unused")
    assert multihost.dist_backend(cfg) == ("nccl" if torch.cuda.is_available() else "gloo")
    assert multihost.dist_backend(cfg.replace(dist_backend="NCCL")) == "nccl"
    monkeypatch.setenv("DIST_BACKEND", "gloo")
    assert multihost.dist_backend(cfg.replace(dist_backend="nccl")) == "gloo"
    monkeypatch.setenv("DIST_BACKEND", "mpi")
    with pytest.raises(ValueError, match="nccl or gloo"):
        multihost.dist_backend(cfg)
