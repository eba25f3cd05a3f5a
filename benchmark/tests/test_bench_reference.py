"""The reference against the port's plain path on the CPU at the tiny
configuration (configs/tiny_synthetic.yaml), with the same seeded weights:
the SOC forward, the engine's masks, the train steps' losses, gradients and
parameters."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import correct
from benchmark.reference import build_reference
from benchmark.reference.engine import reference_video
from benchmark.traffic.videos import Videos
from benchmark.weights import make_weights


HERE = Path(__file__).resolve().parent
CFG = json.loads((HERE / "fixtures/tiny-soc.json").read_text())
SEED = 2 ** 31 + 101


@pytest.fixture(scope="module")
def pair():
    from neurips2023_soc_torch.config import Config
    from neurips2023_soc_torch.models import build_model

    torch.manual_seed(0)
    weights = make_weights(CFG, SEED, "cpu")
    prog = build_model(Config(CFG), device="cpu")
    prog.load_state_dict(weights, strict=True)
    ref = build_reference(CFG, torch.float32, "cpu")
    ref.load_state_dict(weights, strict=True)
    return prog.eval(), ref.eval()


def test_weights_cover_the_programs_state_dict(pair):
    prog, ref = pair
    assert list(prog.state_dict()) == list(ref.state_dict())


@pytest.mark.parametrize("training", [False, True])
def test_soc_forward_equals_the_ports(pair, training):
    prog, ref = pair
    g = torch.Generator().manual_seed(3)
    T, B, H, W = 4, 2, 96, 160
    pixels = torch.randn(T, B, H, W, 3, generator=g)
    pad = torch.zeros(T, B, H, W, dtype=torch.bool)
    pad[:, 1, 80:] = True
    ids = torch.randint(10, 1000, (B, 32), generator=g)
    mask = torch.ones(B, 32, dtype=torch.int32)
    mask[1, 20:] = 0
    outs = []
    for m in (prog, ref):
        rng = torch.Generator().manual_seed(11) if training else None
        with torch.no_grad():
            outs.append(m(pixels, pad, ids, mask, training=training, rng=rng))
    for k in ("pred_masks", "pred_cls", "pred_boxes", "pred_logit", "text_sentence_feature"):
        a, b = outs[0][k].float(), outs[1][k].float()
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


def test_engine_masks_equal_the_reference(pair):
    from neurips2023_soc_torch.inference import InferenceEngine

    prog, ref = pair
    mix = json.loads((HERE / "fixtures/tiny_videos.json").read_text())
    v = Videos(mix, SEED, "cpu")
    eng = InferenceEngine(prog, text_encoder_type=CFG["text_encoder_type"],
                          text_bucket=CFG["text_bucket"], time_buckets=mix["time_buckets"],
                          size_buckets=[tuple(mix["frame_size"])], device="cpu")
    for i in range(len(v.pool)):
        item = v.item(i, i)
        got = eng.infer_video_multi(**item)
        want = reference_video(ref, item["frames"], item["texts"], item["original_size"],
                               mix["time_buckets"], [tuple(mix["frame_size"])],
                               CFG["text_encoder_type"], CFG["text_bucket"])
        gaps = correct.engine_gaps(got, want, item["frames"].shape[0])
        # the engine sends the stride-4 logits through bfloat16 before its resizes:
        # a pixel may flip where |logit| is within bfloat16's rounding of it
        assert gaps["query_score_gap"] < 1e-6
        assert gaps["mask_logit_gap"] < 0.02
        assert gaps["mask_mismatch_share"] < 1e-3


def training_clip(rng: np.random.Generator, T: int, h: int, w: int) -> dict:
    """A seeded clip: normalized pixels, one referred instance whose box drifts
    and is visible in some of the frames, and a sentence."""
    bw, bh = int(rng.uniform(0.15, 0.6) * w), int(rng.uniform(0.15, 0.6) * h)
    x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
    dx, dy = rng.uniform(-0.02, 0.02, 2) * (w, h)
    visible = np.zeros(T, bool)
    visible[rng.choice(T, max(1, int(rng.integers(T // 2, T + 1))), replace=False)] = True
    masks = np.zeros((T, h, w), np.uint8)
    boxes = np.zeros((T, 4), np.float32)
    for t in np.flatnonzero(visible):
        a, b = int(np.clip(x0 + t * dx, 0, w - bw)), int(np.clip(y0 + t * dy, 0, h - bh))
        masks[t, b:b + bh, a:a + bw] = 1
        boxes[t] = (a, b, a + bw, b + bh)
    words = ["the", "man", "left", "dog", "riding", "white", "board", "near"]
    return dict(frames=rng.standard_normal((T, h, w, 3)).astype(np.float32), masks=masks,
                boxes=boxes, visible=visible,
                text=" ".join(rng.choice(words, int(rng.integers(3, 7)))))


def leaf_gap_median(got, want) -> float:
    """The median over leaves of |norm(got) - norm(want)| over the larger of
    norm(want) and the median leaf's norm."""
    g = {k: float(torch.linalg.vector_norm(v.double())) for k, v in got.items()}
    w = {k: float(torch.linalg.vector_norm(v.double())) for k, v in want.items()}
    med = float(np.median(list(w.values())))
    return float(np.median([abs(g[k] - w[k]) / max(w[k], med) for k in w]))


def test_train_steps_equal_the_reference():
    """Three steps of make_train_step (the forward with K1's plain path, the
    criterion and matcher, the backward, the clip, AdamW) against the
    reference's, from the same weights, clips and dropout seeds: each step's
    loss, the first step's clipped gradient (from AdamW's first moment) and
    the parameters' change after the three."""
    from neurips2023_soc_torch.config import Config
    from neurips2023_soc_torch.data.collate import collate_batch
    from neurips2023_soc_torch.losses import build_criterion_config, criterion
    from neurips2023_soc_torch.models import build_model
    from neurips2023_soc_torch.models.text_encoder import build_tokenizer
    from neurips2023_soc_torch.training.optim import build_optimizer
    from neurips2023_soc_torch.training.train_step import (TrainState, device_batch,
                                                           make_train_step)
    from neurips2023_soc_torch.utils.padded import train_size_buckets

    from benchmark.reference import criterion_config
    from benchmark.reference.criterion import Matches
    from benchmark.reference.padded import train_size_buckets as ref_buckets
    from benchmark.reference.train import collate, reference_steps

    rng = np.random.default_rng(SEED)
    clips = [[training_clip(rng, 4, h, w) for h, w in sizes]
             for sizes in ([(96, 160), (88, 150)], [(88, 150), (96, 160)], [(96, 160)] * 2)]
    seeds = [SEED * 1_000_003 + i for i in range(len(clips))]
    weights = make_weights(CFG, SEED, "cpu")

    model = build_model(Config(CFG), device="cpu")
    model.load_state_dict(weights, strict=True)
    opt = build_optimizer(model, lr=CFG["lr"], lr_backbone=CFG["lr_backbone"],
                          text_encoder_lr=CFG["text_encoder_lr"],
                          weight_decay=CFG["weight_decay"], clip_max_norm=CFG["clip_max_norm"],
                          freeze_text=CFG["freeze_text_encoder"])
    state = TrainState(model, opt)
    step = make_train_step(model, build_criterion_config(Config(CFG)))
    tokenizer = build_tokenizer(CFG["text_encoder_type"], CFG["text_bucket"])
    trained = [n for n in opt.labels if opt.labels[n] != "frozen"]
    start = {n: weights[n] for n in trained}
    matches, match = [], criterion.hungarian_match

    def recorder(*a, **k):
        out = match(*a, **k)
        matches.append(out.detach().clone())
        return out

    criterion.hungarian_match = recorder
    try:
        losses = []
        for i, batch in enumerate(clips):
            samples = [dict(frames=c["frames"], text=c["text"], masks=c["masks"][:, None],
                            boxes=c["boxes"][:, None], labels=np.zeros(1, np.int32),
                            is_visible=c["visible"][:, None], referred_instance_idx=0)
                       for c in batch]
            b = collate_batch(samples, tokenizer, size_buckets=train_size_buckets(
                CFG["train_short_size"], CFG["train_max_size"]))
            _, metrics = step(state, device_batch(b, torch.device("cpu")), seeds[i])
            losses.append(float(metrics["loss"]))
            if i == 0:
                grads = {n: opt.adamw.state[opt.params[n]]["exp_avg"] / 0.1 for n in trained
                         if opt.params[n] in opt.adamw.state}
    finally:
        criterion.hungarian_match = match
    change = {n: opt.params[n].detach() - start[n] for n in trained}

    ref = build_reference(CFG, torch.float32, "cpu")
    ref.load_state_dict(weights, strict=True)
    buckets = ref_buckets(CFG["train_short_size"], CFG["train_max_size"])
    batches = [collate(c, buckets, CFG["text_encoder_type"], CFG["text_bucket"], "cpu")
               for c in clips]
    followed = Matches(matches)
    out = reference_steps(ref, batches, seeds, criterion_config(CFG), CFG, followed)
    # float32 on both sides: rounding alone, and the program's assignments are the
    # reference matcher's own best
    assert max(followed.cost_gaps) < 1e-5
    assert max(abs(a - b) / abs(b) for a, b in zip(losses, out["losses"])) < 1e-5
    assert leaf_gap_median(grads, {n: out["grads"][n] for n in grads}) < 1e-4
    assert leaf_gap_median(change, {n: out["params"][n] - start[n] for n in trained}) < 1e-4
