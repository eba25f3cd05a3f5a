"""The golden outputs of the JAX package (tests/torch_golden/, made by
make_golden.py) and the comparisons that hold the port to them: the fixtures
are present and shaped, the seeded weights reproduce the stored fingerprint
key by key, and the tiny golden (g3) holds the port on the CPU through the
same golden.compare_* functions that `chip_smoke.py --golden` runs on the
card, at the same tolerances; a weight perturbed by 1e-2 must fail them.
No JAX runs here and no full-width model is built."""
from pathlib import Path

import numpy as np
import pytest
import torch

from neurips2023_soc_torch import golden
from neurips2023_soc_torch.convert import (param_rules, seeded_array, seeded_state_dict,
                                           weights_fingerprint)
from neurips2023_soc_torch.models.common import Dropout
from neurips2023_soc_torch.models.soc import SOC
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)

GOLDEN = Path(__file__).resolve().parent / "torch_golden"


@pytest.fixture(scope="module")
def meta():
    return golden.load_meta(GOLDEN)


@pytest.fixture(scope="module")
def g3():
    return golden.load_golden(GOLDEN, "g3")


def test_fixtures_present_and_shaped(meta):
    files = sorted(p.name for p in GOLDEN.glob("*.npz"))
    assert files == ["g1.npz", "g2.npz", "g3.npz"]
    assert sum(p.stat().st_size for p in GOLDEN.iterdir() if p.is_file()) < 6 * 2**20
    for k in ("versions", "fingerprint", "seconds", "g1", "g2", "g3"):
        assert k in meta
    assert meta["g1"]["video"] == [16, 360, 640, 3] and meta["g1"]["expression"] == \
        golden.EXPRESSION
    g1 = golden.load_golden(GOLDEN, "g1")
    soc = g1["soc"]
    assert soc["pred_cls"].shape == (16, 20, 1) and soc["pred_boxes"].shape == (16, 20, 4)
    assert soc["pred_masks_q"].shape == (16, 90, 160) and soc["query"].shape == (1,)
    assert [soc[f"level{i}"].shape for i in range(4)] == [
        (4, 45, 80, 16), (4, 23, 40, 16), (4, 12, 20, 16), (4, 6, 10, 16)]
    assert golden.unpack_masks(g1["engine"]).shape == (16, 360, 640)
    step = golden.load_golden(GOLDEN, "g2")["step"]
    assert len(step["grad_keys"]) == len(meta["fingerprint"]["full"]) == 822
    assert step["samples"].shape == (golden.GRAD_TENSORS * golden.GRAD_SAMPLES,)
    assert np.isfinite(step["losses"]).all() and step["assign"].shape[0] == 3


# one key of each rule at full width (Video-Swin-B SOC, roberta-base)
FULL_KEYS = [
    ("backbone.0.body.layers.2.blocks.17.attn.relative_position_bias_table", (2535, 16),
     "normal:1.5"),
    ("transformer.encoder.layers.1.self_attn.sampling_offsets.weight", (256, 256),
     "normal:0.05"),
    ("transformer.decoder.layers.2.cross_attn.sampling_offsets.bias", (256,), "grid:8,4,4"),
    ("text_encoder.encoder.layer.11.output.LayerNorm.weight", (768,), "norm"),
    ("voc.transformer_ffn_layers.2.linear1.bias", (2048,), "bias"),
]


@pytest.mark.parametrize("key,shape,rule", FULL_KEYS,
                         ids=["table", "offsets_weight", "offsets_grid", "norm", "bias"])
def test_seeded_key_reproduces_fingerprint(meta, key, shape, rule):
    """One key made alone reproduces the fingerprint of the full-width
    weights the goldens ran."""
    arr = seeded_array(key, shape, rule, meta["g1"]["weights_seed"])
    golden.check_fingerprint(weights_fingerprint({key: arr}),
                             {key: meta["fingerprint"]["full"][key]})


def test_full_width_rules(meta):
    """The rules seeded_state_dict takes for those keys (the full-width
    model built on the meta device: no memory, no compute)."""
    from neurips2023_soc_torch.config import load_config
    from neurips2023_soc_torch.models import build_model

    cfg = load_config(GOLDEN.parents[1] / meta["g1"]["config"]["path"],
                      overrides=meta["g1"]["config"]["overrides"])
    with torch.device("meta"):
        rules = param_rules(build_model(cfg, device="meta"))
    assert sorted(rules) == sorted(meta["fingerprint"]["full"])
    for key, shape, rule in FULL_KEYS:
        assert rules[key] == (shape, rule)


@pytest.fixture(scope="module")
def tiny_sd(meta):
    """The tiny golden's seeded weights, checked against its fingerprint."""
    sd = seeded_state_dict(SOC(**meta["g3"]["soc_kwargs"]),
                           meta["g3"]["inference"]["weights_seed"])
    golden.check_fingerprint(weights_fingerprint(sd), meta["fingerprint"]["tiny"])
    return sd


def tiny_model(meta, sd, dropout=None):
    kw = dict(meta["g3"]["soc_kwargs"])
    tm = SOC(**({} if dropout is None else {"dropout": dropout}), **kw)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    for m in tm.modules():
        if dropout == 0.0 and isinstance(m, Dropout):
            m.p = 0.0
    return tm.eval()


def perturb(model):
    """One weight of the model moved by 1e-2 (every entry of a stage-3 Swin
    MLP kernel, seeded)."""
    w = model.backbone[0].body.layers[2].blocks[0].mlp.fc1.weight
    with torch.no_grad():
        w.add_(1e-2 * torch.from_numpy(
            np.random.RandomState(0).standard_normal(tuple(w.shape)).astype(np.float32)))


@pytest.mark.parametrize("perturbed", [False, True], ids=["port", "control"])
def test_g3_inference(meta, g3, tiny_sd, perturbed):
    """The port's SOC outputs and engine masks against the tiny golden at the
    card's f32 tolerances; with one weight perturbed by 1e-2 they fail."""
    inf = meta["g3"]["inference"]
    tm = tiny_model(meta, tiny_sd)
    if perturbed:
        perturb(tm)
    soc, masks = golden.port_inference(tm, "roberta-tiny", inf)
    T = inf["video"][0]

    def compare():
        golden.compare_soc(soc, g3["soc"], golden.TOL_F32, T)
        golden.compare_engine(masks, soc, g3["engine"], g3["soc"], T, golden.PROB_TOL)

    if perturbed:
        with pytest.raises(golden.GoldenMismatch):
            compare()
    else:
        compare()


@pytest.mark.parametrize("perturbed", [False, True], ids=["port", "control"])
def test_g3_step(meta, g3, tiny_sd, perturbed):
    """One training step's losses, matcher, gradient norms and sampled
    gradients against the tiny golden; a perturbed weight fails."""
    st = meta["g3"]["step"]
    tm = tiny_model(meta, tiny_sd, dropout=0.0)
    if perturbed:
        perturb(tm)
    b = golden.step_batch("roberta-tiny", *st["clip"][1:])
    assert golden.batch_fingerprint(b) == st["batch"]
    rec = golden.port_step_record(tm, b, list(g3["step"]["sample_keys"]))
    if perturbed:
        with pytest.raises(golden.GoldenMismatch):
            golden.compare_step(rec, g3["step"], golden.STEP_TOL)
    else:
        golden.compare_step(rec, g3["step"], golden.STEP_TOL)


def test_engine_rule_without_prob_tol(g3, meta):
    """The bf16 rule of compare_engine: a flipped mask pixel passes where
    JAX's upsampled logit lies within the logit error bound of 0, and fails
    where it lies beyond."""
    T = meta["g3"]["inference"]["video"][0]
    want = golden.unpack_masks(g3["engine"])
    logit = golden.upsampled_logits(g3["soc"], *want.shape[1:]).reshape(-1)
    bound = 2.0 ** -8 * float(np.abs(g3["soc"]["pred_masks_q"]).max())
    for idx, ok in ((int(np.argmin(np.abs(logit))), True), (int(np.argmax(np.abs(logit))), False)):
        assert (np.abs(logit[idx]) <= bound) == ok
        got = want.copy().reshape(-1)
        got[idx] ^= 1
        rep = golden.compare_engine(got.reshape(want.shape), g3["soc"], g3["engine"], g3["soc"],
                                    T, raise_on_fail=False)
        assert rep["differ"] == 1 and rep["failed"] == float(not ok)


def test_training_step_after_an_inference_mode_forward(meta, tiny_sd):
    """The port caches geometry tensors (Swin relative-position rows and
    region ids, the MSDA level sizes) on first use. A forward under
    torch.inference_mode at a geometry no earlier call used (an evaluator's
    pass) must not leave inference tensors there for a later training step
    to save for its backward."""
    b = golden.step_batch("roberta-tiny", 1, 64, 96)
    px, pad = torch.from_numpy(b["pixels"]), torch.from_numpy(b["pad_mask"])
    ids, msk = torch.from_numpy(b["text_ids"]), torch.from_numpy(b["text_mask"])
    tm = tiny_model(meta, tiny_sd, dropout=0.0)
    with torch.inference_mode():
        tm(px, pad, ids, msk)
    out = tm(px, pad, ids, msk, training=True, rng=torch.Generator())
    out["pred_masks"].float().square().mean().backward()
    assert tm.backbone[0].body.layers[0].blocks[0].attn.relative_position_bias_table.grad \
        is not None
