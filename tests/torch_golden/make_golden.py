"""Make the golden outputs of the JAX package that hold the PyTorch port to
it at full width, on the CPU:

    JAX_PLATFORMS=cpu python tests/torch_golden/make_golden.py [--only g1 g2 g3]
    JAX_PLATFORMS=cpu python tests/torch_golden/make_golden.py --floor

Both frameworks run the same weights, rebuilt from a seed by
neurips2023_soc_torch.convert.seeded_state_dict (numpy's legacy RandomState,
fixed across numpy releases) and carried into JAX through the JAX package's
convert_torch_state_dict (its missing and unused reports must be empty). The
JAX side runs as the JAX suite runs on the CPU: float32, the default `xla`
window attention and `msda_impl: auto` (the XLA MSDA on the CPU).

  g1  inference on the main path: configs/refer_youtube_vos.yaml with
      backbone video-swin-b and compute_dtype float32, one 16 x 360 x 640
      uint8 video from RandomState(0) and the expression "a person riding a
      bike": the InferenceEngine's masks (infer_videos) and near-threshold
      probabilities, and SOC.apply's outputs (golden.soc_record).
  g2  one training step of the same model, dropout off, on one
      SyntheticRVOSDataset clip (seed 0) at 360 x 640 (T in meta.json):
      backbone_features without drop path, the head in training mode, the
      criterion and the gradients (golden.step_record).
  g3  the tiny twin of g1 and g2 (the port tests' video-swin-t, d_model 64,
      roberta-tiny config at 2 x 96 x 128), which tier-1 compares on the CPU.

Writes tests/torch_golden/{g1,g2,g3}.npz (zip entries with fixed times, so a
second run writes the same bytes) and meta.json (seeds, config overrides,
input and weight fingerprints, versions; only its `seconds` differ between
runs). `--floor` instead runs the port on the CPU against the stored goldens
and prints every error of golden.compare_*: the floor the card's tolerances
are set from.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import resource
import sys
import time
import zipfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path[:0] = [str(ROOT), str(HERE.parent)]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from neurips2023_soc_torch import golden  # noqa: E402
from neurips2023_soc_torch.convert import (seeded_state_dict, state_dict_from_jax,  # noqa: E402
                                           weights_fingerprint)

jax.config.update("jax_platforms", "cpu")

SEED = 0
INPUT_SEED = 0
G1_OVERRIDES = {"backbone": "video-swin-b", "compute_dtype": "float32"}
G1_SHAPE = (16, 360, 640)
G2_T = 8
TINY_KW = dict(backbone_name="video-swin-t", d_model=64, num_queries=5, dim_feedforward=128,
               enc_layers=1, dec_layers=2, voc_enc_layers=1, voc_dec_layers=1,
               text_encoder_type="roberta-tiny")
G3_SHAPE = (2, 96, 128)
TEXT_BUCKET = 32


def save_npz(path: Path, records: dict) -> None:
    """{record: {key: array}} as '<record>/<key>.npy' zip entries with a
    fixed date, deflated: the same arrays give the same bytes."""
    with zipfile.ZipFile(path, "w") as zf:
        for rec in sorted(records):
            for key in sorted(records[rec]):
                buf = io.BytesIO()
                np.lib.format.write_array(buf, np.ascontiguousarray(records[rec][key]),
                                          allow_pickle=False)
                info = zipfile.ZipInfo(f"{rec}/{key}.npy", date_time=(1980, 1, 1, 0, 0, 0))
                info.compress_type = zipfile.ZIP_DEFLATED
                zf.writestr(info, buf.getvalue())


# ---------------------------------------------------------------- models
def configs(name: str, dropout=None):
    """(JAX config or None, port config or None, SOC kwargs or None) of a golden."""
    if name == "tiny":
        return None, None, dict(TINY_KW)
    from neurips2023_soc_torch.config import load_config as port_config
    from neurips2023_soc_tpu.config import load_config as jax_config

    path = ROOT / "configs" / "refer_youtube_vos.yaml"
    jc, pc = jax_config(path, overrides=G1_OVERRIDES), port_config(path, overrides=G1_OVERRIDES)
    if dropout is not None:
        jc.DeformTransformer["dropout"] = pc.DeformTransformer["dropout"] = dropout
    return jc, pc, None


def port_model(name: str, dropout=None):
    """The port's SOC on the CPU with the seeded weights, and those weights
    (numpy); dropout set to `dropout` when given."""
    from neurips2023_soc_torch.models import build_model
    from neurips2023_soc_torch.models.common import Dropout
    from neurips2023_soc_torch.models.soc import SOC

    _, pc, kw = configs(name, dropout)
    if kw is not None:
        tm = SOC(**({} if dropout is None else {"dropout": dropout}), **kw)
    else:
        tm = build_model(pc, device="cpu")
    sd = seeded_state_dict(tm, SEED)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    for m in tm.modules():
        if dropout is not None and isinstance(m, Dropout):
            m.p = dropout
    return tm.eval(), sd


def build_pair(name: str, example_inputs, dropout=None):
    """(JAX SOC, its params: the seeded weights through the JAX package's
    convert_torch_state_dict, which must report nothing missing or unused,
    the weights' fingerprint)."""
    from neurips2023_soc_tpu.models import build_model as jax_build
    from neurips2023_soc_tpu.models.soc import SOC as JaxSOC
    from neurips2023_soc_tpu.training.convert import convert_torch_state_dict, flax_to_torch

    jc, _, kw = configs(name, dropout)
    if kw is not None:
        jm = JaxSOC(**({} if dropout is None else {"dropout": dropout}), **kw)
    else:
        jm = jax_build(jc)
    _, sd = port_model(name, dropout)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *example_inputs)
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    unmapped = ["/".join(str(getattr(k, "key", k)) for k in path[1:]) for path, _ in leaves
                if flax_to_torch(tuple(str(getattr(k, "key", k)) for k in path[1:])) is None]
    empty = jax.tree_util.tree_map(lambda s: np.empty(s.shape, s.dtype), shapes)
    params, report = convert_torch_state_dict(sd, empty)
    if report["missing"] or report["unused"] or unmapped:
        raise RuntimeError(f"seeded weights -> JAX: missing {report['missing'][:5]}, unused "
                           f"{report['unused'][:5]}, without a torch key {unmapped[:5]}")
    return jm, params, weights_fingerprint(sd)


def text_encoder_of(name: str) -> str:
    return "roberta-tiny" if name == "tiny" else "roberta-base"


def tokenizer_of(name: str):
    from neurips2023_soc_tpu.models.text_encoder import build_tokenizer

    return build_tokenizer(text_encoder_of(name), TEXT_BUCKET)


# ---------------------------------------------------------------- inference (g1, g3)
def jax_inference(name: str, shape) -> tuple:
    """The JAX engine's masks and probabilities, and SOC.apply's record."""
    from neurips2023_soc_tpu.inference import InferenceEngine

    T, H, W = shape
    video = golden.golden_videos(1, T, H, W, INPUT_SEED)[0]
    ids, msk = tokenizer_of(name)([golden.EXPRESSION])
    px = golden.normalize_u8(video)
    pad = np.zeros(px.shape[:4], bool)
    jm, params, fp = build_pair(name, (px, pad, ids, msk))
    engine = InferenceEngine(jm, params, text_encoder_type=text_encoder_of(name),
                             text_bucket=TEXT_BUCKET, time_buckets=(T,), size_buckets=((H, W),))
    (masks,), = list(engine.infer_videos([dict(frames=video, texts=[golden.EXPRESSION])]))
    probs = engine.infer_video(video, golden.EXPRESSION, return_probs=True)
    if not np.array_equal(masks, (probs > 0.5).astype(np.uint8)):
        raise RuntimeError("the engine's masks are not its probabilities thresholded")
    feats = jax.jit(lambda p, x: jm.apply(p, x, pad, method=jm.backbone_features))(params, px)
    out = jax.jit(lambda p, f: jm.apply(p, f, pad, ids, msk, method=jm.head))(params, feats)
    soc = golden.soc_record(golden.to_numpy(out), golden.to_numpy(list(feats)), T)
    # the engine chose SOC.apply's query: its probabilities are that query's
    # logits through the engine's own finalize, up to the last bits of two
    # XLA programs (the engine's fused clip program and this split one)
    logits = jax.numpy.asarray(out["pred_masks"][-1][:, 0]).astype(jax.numpy.bfloat16)
    finalize = engine._get_finalize()
    q = int(golden.scalar(soc["query"]))
    gaps = [float(np.abs(np.asarray(finalize(logits, np.int32(k), H=H, W=W, fh=H, fw=W, oh=H,
                                             ow=W, want_probs=True)) - probs).max())
            for k in range(logits.shape[1])]
    if int(np.argmin(gaps)) != q or gaps[q] > 1e-2:
        raise RuntimeError(f"the engine's probabilities against each query's: {gaps}")
    meta = {"video": [T, H, W, 3], "video_seed": INPUT_SEED, "expression": golden.EXPRESSION,
            "text_ids": ids.tolist(), "text_mask": msk.tolist(), "weights_seed": SEED,
            "engine": {"time_buckets": [T], "size_buckets": [[H, W]],
                       "text_bucket": TEXT_BUCKET},
            "jax_query": q, "jax_margin": golden.margin(soc["score_sums"], T)}
    return {"soc": soc, "engine": golden.engine_record(masks, probs)}, meta, fp


# ---------------------------------------------------------------- training (g2, g3)
def jax_step(name: str, shape) -> tuple:
    """One jitted value_and_grad of the JAX SOC (torch_port_helpers.
    train_step_pair's recipe) and the matcher's rows of its outputs."""
    from neurips2023_soc_torch.training.train_step import TARGET_KEYS
    from neurips2023_soc_tpu.losses import CriterionConfig, compute_criterion, total_loss
    from neurips2023_soc_tpu.losses.matcher import compute_cost_matrix, hungarian_match
    from neurips2023_soc_tpu.ops import resize_bilinear
    from torch_port_helpers import NoFlaxDropout

    b = golden.step_batch(text_encoder_of(name), *shape, seed=INPUT_SEED)
    inputs = [b[k] for k in ("pixels", "pad_mask", "text_ids", "text_mask")]
    jm, params, fp = build_pair(name, inputs, dropout=0.0)
    targets = {k: b[k] for k in TARGET_KEYS}
    cfg = CriterionConfig()

    def loss_fn(p):
        feats = jm.apply(p, b["pixels"], b["pad_mask"], method=jm.backbone_features)
        out = jm.apply(p, feats, b["pad_mask"], b["text_ids"], b["text_mask"],
                       sample_sizes=b["sample_sizes"], training=True, method=jm.head,
                       rngs={"dropout": jax.random.PRNGKey(1)})
        losses = compute_criterion(out, targets, cfg)
        return total_loss(losses, cfg), (losses, out)

    def step(p):
        (loss, (losses, out)), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        Ht, Wt = targets["masks"].shape[-2:]
        assign, rows = [], []
        for lvl in range(out["pred_masks"].shape[0]):
            layer = {k: out[k][lvl] for k in ("pred_masks", "pred_cls", "pred_boxes",
                                               "pred_logit")}
            layer["text_sentence_feature"] = out["text_sentence_feature"]
            up = resize_bilinear(layer["pred_masks"].astype(jax.numpy.float32)[..., None],
                                 Ht, Wt, align_corners=False)[..., 0]
            rows.append(compute_cost_matrix(layer, targets, up, cfg.costs)[0, :, 0])
            assign.append(hungarian_match(layer, targets, up, cfg.costs))
        return loss, losses, grads, assign, rows

    with NoFlaxDropout():
        loss, losses, grads, assign, rows = jax.jit(step)(params)
    scalars = {k: float(v) for k, v in losses.items()}
    scalars["loss"] = float(loss)
    rec = golden.step_record(scalars, state_dict_from_jax(golden.to_numpy(grads)),
                             golden.to_numpy(assign), golden.to_numpy(rows))
    meta = {"clip": [1, *shape], "dataset": "SyntheticRVOSDataset(num_samples=1, seed=0)",
            "weights_seed": SEED, "dropout": 0.0, "batch": golden.batch_fingerprint(b)}
    return {"step": rec}, meta, fp


# ---------------------------------------------------------------- the CPU floor
def floor(names) -> None:
    """The port on this CPU against the stored goldens: every error that
    golden.compare_* computes, none raised."""
    meta = golden.load_meta(HERE)
    for name in names:
        g = golden.load_golden(HERE, name)
        size = "tiny" if name == "g3" else "full"
        parts = (("inference", "step") if name == "g3" else
                 ("inference",) if name == "g1" else ("step",))
        for part in parts:
            inf = meta[name]["inference"] if name == "g3" else meta[name]
            t0 = time.perf_counter()
            if part == "inference":
                tm, sd = port_model(size)
                golden.check_fingerprint(weights_fingerprint(sd), meta["fingerprint"][size])
                soc, masks = golden.port_inference(tm, text_encoder_of(size), inf)
                T = inf["video"][0]
                rep = golden.compare_soc(soc, g["soc"], 0.0, T, raise_on_fail=False)
                eng = golden.compare_engine(masks, soc, g["engine"], g["soc"], T, 0.0,
                                            raise_on_fail=False)
                print(f"{name} inference floor: {json.dumps(rep)}")
                print(f"{name} engine floor: {json.dumps(eng)}")
            else:
                st = meta[name]["step"] if name == "g3" else meta[name]
                tm, _ = port_model(size, dropout=0.0)
                b = golden.step_batch(text_encoder_of(size), *st["clip"][1:])
                golden.check_batch(golden.batch_fingerprint(b), st["batch"])
                rec = golden.port_step_record(tm, b, list(g["step"]["sample_keys"]))
                rep = golden.compare_step(rec, g["step"], 0.0, raise_on_fail=False)
                print(f"{name} step floor: {json.dumps(rep)}")
            print(f"{name} {part}: {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------- main
def make(names) -> None:
    meta_path = HERE / "meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    meta.update({"versions": {"jax": jax.__version__, "flax": __import__("flax").__version__,
                              "numpy": np.__version__},
                 "jax_side": "float32, swin_attn_impl xla, msda_impl auto (XLA on the CPU)"})
    meta.setdefault("seconds", {})
    meta.setdefault("fingerprint", {})
    for name in names:
        t0 = time.perf_counter()
        if name == "g1":
            recs, m, fp = jax_inference("full", G1_SHAPE)
            m["config"] = {"path": "configs/refer_youtube_vos.yaml", "overrides": G1_OVERRIDES}
            meta["fingerprint"]["full"] = fp
        elif name == "g2":
            recs, m, fp = jax_step("full", (G2_T, 360, 640))
            m["config"] = {"path": "configs/refer_youtube_vos.yaml", "overrides": G1_OVERRIDES,
                           "DeformTransformer.dropout": 0.0}
            meta["fingerprint"]["full"] = fp
        else:
            recs, m, fp = jax_inference("tiny", G3_SHAPE)
            step_recs, sm, _ = jax_step("tiny", G3_SHAPE)
            recs.update(step_recs)
            m = {"inference": m, "step": sm, "soc_kwargs": TINY_KW}
            meta["fingerprint"]["tiny"] = fp
        save_npz(HERE / f"{name}.npz", recs)
        meta[name] = m
        meta["seconds"][name] = round(time.perf_counter() - t0, 1)
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        print(f"{name}: {meta['seconds'][name]} s, peak RSS so far {peak:.1f} GiB, "
              f"{(HERE / f'{name}.npz').stat().st_size} bytes", flush=True)
        meta_path.write_text(json.dumps(meta, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=("g1", "g2", "g3"), default=["g3", "g1", "g2"])
    ap.add_argument("--floor", action="store_true",
                    help="run the port on the CPU against the stored goldens")
    args = ap.parse_args()
    if args.floor:
        floor(args.only)
    else:
        make(args.only)
