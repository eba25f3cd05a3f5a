"""Golden outputs of the JAX package, and the comparisons that hold the port
to them.

`tests/torch_golden/make_golden.py` runs the JAX SOC on seeded weights
(convert.seeded_state_dict) and seeded inputs and stores, per golden, what
this module extracts from a forward or a training step (`soc_record`,
`engine_record`, `step_record`). `chip_smoke.py --golden` and the tier-1
tests extract the same records from the port's outputs and hold them to the
stored ones with `compare_soc`, `compare_engine` and `compare_step`: one
implementation on both sides. Everything here is numpy apart from the
conversion of the port's tensors.

Errors are relative to each tensor's scale: max |got - want| / max |want|
(1 where the tensor is all zero), so one tolerance fits mask logits in the
hundreds and boxes in [0, 1] alike.
"""
from __future__ import annotations

import json
import zlib
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .data.collate import IMAGENET_MEAN, IMAGENET_STD

EXPRESSION = "a person riding a bike"
# sampled entries per gradient tensor, and how many of the largest tensors
GRAD_SAMPLES, GRAD_TENSORS = 64, 20
KEY_NORM_FLOOR = 1e-4
# tolerances of the comparisons (PERF.md §6): SOC outputs in float32 as a
# share of each tensor's scale, the JAX probability within which a mask pixel
# may differ, the training step's; SOC outputs in bfloat16 (whose mask pixels
# may differ where the measured logit error explains it: compare_engine)
TOL_F32, PROB_TOL, STEP_TOL = 1e-4, 1e-2, 1e-3
BF16_TOL = 1e-1
# JAX probabilities stored for the engine check: every pixel within this of 0.5
NEAR_THRESHOLD = 0.05


def golden_videos(n: int, T: int, H: int, W: int, seed: int = 0) -> List[np.ndarray]:
    """`n` uint8 (T, H, W, 3) videos from one RandomState(seed), in order."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (T, H, W, 3)).astype(np.uint8) for _ in range(n)]


def normalize_u8(video: np.ndarray) -> np.ndarray:
    """uint8 (T, H, W, 3) -> the (T, 1, H, W, 3) float32 ImageNet-normalized
    clip both engines make on the device (no padding)."""
    return ((video.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)[:, None]


def step_batch(text_encoder_type: str, T: int, H: int, W: int, seed: int = 0,
               text_bucket: int = 32) -> dict:
    """One collated SyntheticRVOSDataset clip (num_samples 1, `seed`) at
    T x H x W: the training goldens' batch."""
    from .data import SyntheticRVOSDataset, iterate_batches
    from .models.text_encoder import build_tokenizer

    ds = SyntheticRVOSDataset(num_samples=1, num_frames=T, frame_size=(H, W), seed=seed)
    tok = build_tokenizer(text_encoder_type, text_bucket)
    return next(iter(iterate_batches(ds, 1, tok, seed=seed, size_buckets=((H, W),))))


def batch_fingerprint(batch: Mapping) -> Dict[str, list]:
    """{key: [sum, sum of squares]} in float64 of a batch's arrays."""
    return {k: [float(np.asarray(v, np.float64).sum()),
                float(np.square(np.asarray(v, np.float64)).sum())]
            for k, v in sorted(batch.items()) if hasattr(v, "ndim")}


def check_batch(got: Mapping[str, list], want: Mapping[str, list]) -> None:
    """Raises unless two batch fingerprints agree within 1e-10."""
    if sorted(got) != sorted(want) or any(
            abs(a - b) > 1e-10 * max(1.0, abs(b)) for k in want for a, b in zip(got[k], want[k])):
        raise GoldenMismatch(f"the batch differs from the golden's: {got} against {want}")


def to_numpy(tree):
    """Tensors (torch, jax) and nested lists/tuples/dicts of them -> numpy."""
    if isinstance(tree, Mapping):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if hasattr(tree, "detach"):
        return tree.detach().float().cpu().numpy()
    return np.asarray(tree)


def level_sample(x: np.ndarray) -> np.ndarray:
    """A strided sample of one backbone level (B*T, h, w, C): every 4th frame,
    every 2nd pixel, 16 channels."""
    return np.ascontiguousarray(x[::4, ::2, ::2, ::max(1, x.shape[-1] // 16)])


def scores_of(out: Mapping[str, np.ndarray], t: int) -> np.ndarray:
    """Per-query score sums over the first `t` frames of the last emitted
    layer, batch entry 0 (both engines' selection: the argmax)."""
    cls = out["pred_cls"][-1][:, 0].astype(np.float64)  # (T, Nq, K)
    return (1.0 / (1.0 + np.exp(-cls))).max(-1)[:t].sum(0)


def soc_record(out: Mapping[str, np.ndarray], features: Sequence[np.ndarray], t: int
               ) -> Dict[str, np.ndarray]:
    """What a golden keeps of one clip forward (numpy outputs of SOC.apply
    or the port's SOC, batch 1): the last layer's pred_cls, pred_boxes and
    pred_logit for every query, the score sums, the chosen query (their
    argmax) and its stride-4 mask logits, the sentence feature, and a sample
    of each backbone level."""
    sums = scores_of(out, t)
    q = int(np.argmax(sums))
    rec = {
        "pred_cls": out["pred_cls"][-1][:, 0],
        "pred_boxes": out["pred_boxes"][-1][:, 0],
        "pred_logit": out["pred_logit"][-1],
        "pred_masks_q": out["pred_masks"][-1][:, 0][:, q],
        "text_sentence_feature": out["text_sentence_feature"],
        "score_sums": sums,
    }
    for i, f in enumerate(features):
        rec[f"level{i}"] = level_sample(np.asarray(f))
    rec = {k: np.ascontiguousarray(np.asarray(v, np.float32)) for k, v in rec.items()}
    rec["query"] = np.array([q], np.int64)
    return rec


def engine_record(masks: np.ndarray, probs: np.ndarray) -> Dict[str, np.ndarray]:
    """An engine's final masks (T, H, W) in {0, 1}, bit-packed along width,
    and the flat indices and probabilities of every pixel within
    NEAR_THRESHOLD of 0.5 (the pixels a last-bit difference may flip)."""
    near = np.flatnonzero(np.abs(probs.reshape(-1) - 0.5) < NEAR_THRESHOLD)
    return {"masks_packed": np.packbits(masks.astype(np.uint8), axis=-1),
            "masks_shape": np.array(masks.shape, np.int64),
            "near_index": near.astype(np.int64),
            "near_prob": probs.reshape(-1)[near].astype(np.float32)}


def unpack_masks(rec: Mapping[str, np.ndarray]) -> np.ndarray:
    shape = tuple(int(s) for s in rec["masks_shape"])
    return np.unpackbits(rec["masks_packed"], axis=-1)[..., :shape[-1]].reshape(shape)


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (1 for an all-zero `want`)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise ValueError(f"shape {got.shape} against the golden's {want.shape}")
    if not want.size:
        return 0.0
    scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / (scale if scale > 0 else 1.0)


def scalar(a) -> float:
    """A stored scalar (0-d or one element) as a float."""
    return float(np.asarray(a).reshape(-1)[0])


class GoldenMismatch(AssertionError):
    pass


def _fail_if(bad: List[str], what: str) -> None:
    if bad:
        raise GoldenMismatch(f"{what}: " + "; ".join(bad))


def margin(sums: np.ndarray, t: int) -> float:
    """The top-two gap of the mean scores (score sums over t frames)."""
    s = np.sort(np.asarray(sums, np.float64))[::-1] / t
    return float(s[0] - s[1]) if s.size > 1 else float("inf")


def choice(got_soc: Mapping[str, np.ndarray], want_soc: Mapping[str, np.ndarray], t: int
           ) -> Dict[str, float]:
    """The chosen query on both sides, JAX's top-two margin of the mean
    scores, the largest error of a mean score, and whether a different
    choice is a near tie: two scores can swap only if each moved by half the
    margin, so a swap is a near tie when JAX's margin is at most twice the
    measured score error, and a fault otherwise."""
    err = float(np.abs(np.asarray(got_soc["score_sums"], np.float64)
                       - want_soc["score_sums"]).max()) / t
    m = margin(want_soc["score_sums"], t)
    q, jq = scalar(got_soc["query"]), scalar(want_soc["query"])
    return {"query": float(q), "jax_query": float(jq), "margin": m, "score_err": err,
            "same_query": float(q == jq), "near_tie": float(m <= 2 * err)}


def compare_soc(got: Mapping[str, np.ndarray], want: Mapping[str, np.ndarray], tol: float,
                t: int, raise_on_fail: bool = True) -> Dict[str, float]:
    """Every tensor of soc_record within `tol` of its scale, the chosen
    query JAX's unless that is a near tie (`choice`), and then the chosen
    query's stride-4 mask logits within `tol` too. Returns {key: error} and
    the entries of `choice`."""
    errs = {k: rel_err(got[k], w) for k, w in want.items()
            if k not in ("query", "pred_masks_q")}
    ch = choice(got, want, t)
    bad = [f"{k} {e:.3e}" for k, e in errs.items() if e > tol]
    if not ch["same_query"] and not ch["near_tie"]:
        bad.append(f"chosen query {int(ch['query'])} against JAX's {int(ch['jax_query'])} at a "
                   f"JAX margin of {ch['margin']:.3e} (score error {ch['score_err']:.3e})")
    if ch["same_query"]:
        errs["pred_masks_q"] = rel_err(got["pred_masks_q"], want["pred_masks_q"])
        if errs["pred_masks_q"] > tol:
            bad.append(f"pred_masks_q {errs['pred_masks_q']:.3e}")
    if raise_on_fail:
        _fail_if(bad, f"SOC outputs against the golden at {tol:g} of scale")
    return {**errs, **ch, "failed": float(bool(bad))}


def upsampled_logits(soc: Mapping[str, np.ndarray], H: int, W: int) -> np.ndarray:
    """A record's chosen query's stride-4 mask logits (T, h, w) bilinearly
    upsampled to (T, H, W), as both engines' finalize does before the
    sigmoid (the engines' content is the whole bucket here)."""
    from .ops import resize_bilinear

    lg = torch.from_numpy(np.ascontiguousarray(soc["pred_masks_q"]))
    return resize_bilinear(lg[..., None], H, W)[..., 0].numpy()


def compare_engine(got_masks: np.ndarray, got_soc: Mapping[str, np.ndarray],
                   want: Mapping[str, np.ndarray], want_soc: Mapping[str, np.ndarray], t: int,
                   prob_tol: Optional[float] = None, raise_on_fail: bool = True
                   ) -> Dict[str, float]:
    """The engine's final masks against JAX's. The chosen query (the record's
    `query`, both engines' argmax) must be JAX's unless that is a near tie
    (`choice`). With JAX's query, a mask pixel may differ only where a
    difference is explained: given `prob_tol`, where JAX's probability is
    within it of 0.5 (float32: the port's logits within 1e-5 of JAX's);
    without it (bfloat16), where JAX's logit, upsampled from its stride-4
    logits, is within the measured error of the port's stride-4 logits plus
    the engines' bfloat16 rounding of them (2^-8 of their scale): the
    bilinear upsample is a convex combination, so no larger error reaches a
    pixel. Returns the counts, the share, and the farthest differing pixel's
    distance from the threshold in JAX's probability (capped at
    NEAR_THRESHOLD) or, without `prob_tol`, its JAX logit over the bound."""
    want_masks = unpack_masks(want)
    if got_masks.shape != want_masks.shape:
        _fail_if([f"masks {got_masks.shape} against {want_masks.shape}"], "engine")
    ch = choice(got_soc, want_soc, t)
    differ = np.flatnonzero(got_masks.reshape(-1) != want_masks.reshape(-1))
    rep = {"differ": float(differ.size), "share": differ.size / max(1, want_masks.size), **ch}
    bad = []
    if not ch["same_query"] and not ch["near_tie"]:
        bad.append(f"chosen query {int(ch['query'])} against JAX's {int(ch['jax_query'])} at a "
                   f"JAX margin of {ch['margin']:.3e} (score error {ch['score_err']:.3e})")
    if prob_tol is not None:
        near = dict(zip(want["near_index"].tolist(), want["near_prob"].tolist()))
        dist = [abs(near[i] - 0.5) if i in near else NEAR_THRESHOLD for i in differ.tolist()]
        rep["farthest"] = max(dist, default=0.0)
        rep["explained"] = float(sum(1 for d in dist if d <= prob_tol))
        rule = f"within {prob_tol:g} of the threshold in JAX's probabilities"
    else:
        scale = float(np.abs(want_soc["pred_masks_q"]).max())
        bound = (rel_err(got_soc["pred_masks_q"], want_soc["pred_masks_q"]) + 2.0 ** -8) * scale
        jax_logit = np.abs(upsampled_logits(want_soc, *want_masks.shape[1:]).reshape(-1)[differ])
        rep["farthest"] = float(jax_logit.max()) / bound if differ.size else 0.0
        rep["logit_bound"] = bound
        rep["explained"] = float((jax_logit <= bound).sum())
        rule = f"within the logit error bound {bound:.4f} of the threshold in JAX's logits"
    if ch["same_query"] and rep["explained"] != differ.size:
        bad.append(f"{differ.size - int(rep['explained'])} of {differ.size} differing pixels lie "
                   f"farther than {rule}")
    if raise_on_fail:
        _fail_if(bad, "engine against the golden")
    rep["failed"] = float(bool(bad))
    return rep


def grad_sample_index(shape: Sequence[int], key: str) -> np.ndarray:
    """GRAD_SAMPLES fixed flat indices into a tensor of `shape`, seeded by
    the CRC-32 of its key."""
    n = int(np.prod(shape))
    rng = np.random.RandomState(zlib.crc32(key.encode()))
    return np.sort(rng.randint(0, n, size=GRAD_SAMPLES))


def step_record(losses: Mapping[str, float], grads: Mapping[str, np.ndarray],
                assign: Sequence[np.ndarray], costs: Sequence[np.ndarray],
                sample_keys: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    """What a golden keeps of one training step: every loss term (and the
    total, key 'loss'), the matcher's query per layer and its cost row, the
    global gradient norm, each parameter's gradient norm by state_dict key,
    and GRAD_SAMPLES fixed entries of each of the GRAD_TENSORS largest
    tensors (or of `sample_keys`)."""
    names = sorted(losses)
    keys = sorted(grads)
    norms = np.array([np.sqrt(np.square(grads[k], dtype=np.float64).sum()) for k in keys])
    if sample_keys is None:
        sample_keys = sorted(sorted(keys, key=lambda k: (-grads[k].size, k))[:GRAD_TENSORS])
    samples = [np.asarray(grads[k]).reshape(-1)[grad_sample_index(grads[k].shape, k)]
               for k in sample_keys]
    return {
        "loss_names": np.array(names), "losses": np.array([losses[k] for k in names], np.float64),
        "assign": np.stack([np.asarray(a).reshape(-1) for a in assign]).astype(np.int64),
        "costs": np.stack([np.asarray(c).reshape(-1) for c in costs]).astype(np.float64),
        "grad_keys": np.array(keys), "grad_norms": norms,
        "grad_norm": np.array(np.sqrt(np.square(norms).sum())),
        "sample_keys": np.array(sample_keys),
        "samples": np.concatenate(samples).astype(np.float32),
    }


def compare_step(got: Mapping[str, np.ndarray], want: Mapping[str, np.ndarray], tol: float,
                 raise_on_fail: bool = True) -> Dict[str, float]:
    """Each loss term and the total within `tol` of max(1, |want|); the
    matcher's queries equal unless JAX's cost margin (second lowest minus
    lowest cost) is under `tol`; the global gradient norm, and each
    parameter's, within `tol` of the golden's (the worst 5 keys named on
    failure); the sampled entries within `tol` of their largest magnitude."""
    bad = []
    rep: Dict[str, float] = {}
    if list(got["loss_names"]) != list(want["loss_names"]):
        raise GoldenMismatch(f"loss terms {list(got['loss_names'])} against "
                             f"{list(want['loss_names'])}")
    lerr = np.abs(got["losses"] - want["losses"]) / np.maximum(1.0, np.abs(want["losses"]))
    rep["losses"] = float(lerr.max())
    bad += [f"{n} {g:.6f} against {w:.6f}" for n, g, w, e in
            zip(want["loss_names"], got["losses"], want["losses"], lerr) if e > tol]
    costs = np.sort(want["costs"], axis=-1)
    margins = costs[:, 1] - costs[:, 0] if costs.shape[-1] > 1 else np.full(len(costs), np.inf)
    rep["cost_margin"] = float(margins.min())
    for i, (g, w, m) in enumerate(zip(got["assign"], want["assign"], margins)):
        if not np.array_equal(g, w) and m > tol:
            bad.append(f"matcher layer {i}: queries {g.tolist()} against {w.tolist()} at a "
                       f"cost margin of {m:.3e}")
    rep["assign_equal"] = float(np.array_equal(got["assign"], want["assign"]))
    got_norm, want_norm = scalar(got["grad_norm"]), scalar(want["grad_norm"])
    rep["grad_norm"] = abs(got_norm - want_norm) / want_norm
    if rep["grad_norm"] > tol:
        bad.append(f"global gradient norm {got_norm:.6f} against {want_norm:.6f}")
    if list(got["grad_keys"]) != list(want["grad_keys"]):
        raise GoldenMismatch("gradient keys differ from the golden's")
    # a key whose gradient the math makes zero (a bias before a GroupNorm,
    # attention over all-zero values) holds rounding alone: its norm's
    # difference counts against KEY_NORM_FLOOR of the global norm
    scale = np.maximum(want["grad_norms"], KEY_NORM_FLOOR * want_norm)
    kerr = np.abs(got["grad_norms"] - want["grad_norms"]) / np.where(scale > 0, scale, 1.0)
    rep["key_norms"] = float(kerr.max())
    worst = np.argsort(-kerr, kind="stable")[:5]
    rep["worst_keys"] = ", ".join(f"{want['grad_keys'][i]} {kerr[i]:.3e}" for i in worst)
    if kerr.max() > tol:
        bad.append(f"per-key gradient norms, worst 5: {rep['worst_keys']}")
    n = GRAD_SAMPLES
    serr = []
    for j, k in enumerate(want["sample_keys"]):
        g, w = got["samples"][j * n:(j + 1) * n], want["samples"][j * n:(j + 1) * n]
        serr.append(rel_err(g, w))
    rep["samples"] = float(max(serr)) if serr else 0.0
    if rep["samples"] > tol:
        j = int(np.argmax(serr))
        bad.append(f"sampled gradient entries of {want['sample_keys'][j]} {serr[j]:.3e}")
    if raise_on_fail:
        _fail_if(bad, f"training step against the golden at {tol:g}")
    rep["failed"] = float(bool(bad))
    return rep


def load_golden(directory, name: str) -> Dict[str, Dict[str, np.ndarray]]:
    """tests/torch_golden/<name>.npz as {record: {key: array}} (keys stored
    as '<record>/<key>')."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(Path(directory) / f"{name}.npz", allow_pickle=False) as z:
        for k in z.files:
            rec, _, key = k.partition("/")
            out.setdefault(rec, {})[key] = z[k]
    return out


def load_meta(directory) -> dict:
    return json.loads((Path(directory) / "meta.json").read_text())


def check_fingerprint(got: Mapping[str, list], want: Mapping[str, list]) -> None:
    """Raises with both values at the first key whose fingerprint differs:
    the same first 4 values, and sums within 1e-10 (numpy's summation order
    may differ between versions)."""
    if sorted(got) != sorted(want):
        raise GoldenMismatch(f"weights fingerprint keys differ: {sorted(set(got) ^ set(want))[:5]}")
    for k in sorted(want):
        g, w = got[k], want[k]
        same = g[2:] == w[2:] and all(abs(a - b) <= 1e-10 * max(1.0, abs(b))
                                      for a, b in zip(g[:2], w[:2]))
        if not same:
            raise GoldenMismatch(f"weights fingerprint of {k}: {g} here, {w} in the golden")


# ---------------------------------------------------------------- the port's side
def port_clip_record(model, video: np.ndarray, ids: np.ndarray, msk: np.ndarray
                     ) -> Dict[str, np.ndarray]:
    """soc_record of the port's SOC on one uint8 video (T, H, W, 3) and one
    tokenized expression, on the model's device, without gradient."""
    dev = next(model.parameters()).device
    px = torch.from_numpy(normalize_u8(video)).to(dev)
    pad = torch.zeros(px.shape[:4], dtype=torch.bool, device=dev)
    with torch.no_grad():
        feats = model.backbone_features(px, pad)
        out = model.head(feats, pad, torch.from_numpy(ids).to(dev),
                         torch.from_numpy(msk).to(dev))
        return soc_record(to_numpy(out), [to_numpy(f) for f in feats], video.shape[0])


def matcher_rows(out: Mapping[str, torch.Tensor], targets: Mapping[str, torch.Tensor],
                 costs) -> tuple:
    """Per decoder layer of a training forward: the matcher's (B, N) queries
    and the cost of every query for the first instance of sample 0."""
    from .losses.matcher import compute_cost_matrix, hungarian_match
    from .ops import resize_bilinear

    Ht, Wt = targets["masks"].shape[-2:]
    assign, rows = [], []
    with torch.no_grad():
        for lvl in range(out["pred_masks"].shape[0]):
            layer = {k: out[k][lvl] for k in ("pred_masks", "pred_cls", "pred_boxes",
                                               "pred_logit")}
            layer["text_sentence_feature"] = out["text_sentence_feature"]
            up = resize_bilinear(layer["pred_masks"].float()[..., None], Ht, Wt)[..., 0]
            rows.append(compute_cost_matrix(layer, targets, up, costs)[0, :, 0])
            assign.append(hungarian_match(layer, targets, up, costs))
    return [to_numpy(a) for a in assign], [to_numpy(r) for r in rows]


def port_step_record(model, batch: Mapping[str, np.ndarray],
                     sample_keys: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    """step_record of one training step of the port's SOC on a collated
    batch: backbone_features without drop path, the head in training mode
    (the caller sets dropout to 0), the criterion of the default
    CriterionConfig (configs/refer_youtube_vos.yaml's weights) and the
    backward; the gradients are dropped after."""
    from .losses import CriterionConfig, compute_criterion, total_loss
    from .training.train_step import TARGET_KEYS, device_batch

    dev = next(model.parameters()).device
    cfg = CriterionConfig()
    b = device_batch(dict(batch), dev)
    targets = {k: b[k] for k in TARGET_KEYS}
    feats = model.backbone_features(b["pixels"], b["pad_mask"])
    out = model.head(feats, b["pad_mask"], b["text_ids"], b["text_mask"],
                     sample_sizes=b["sample_sizes"], training=True,
                     rng=torch.Generator(device=dev))
    losses = compute_criterion(out, targets, cfg)
    loss = total_loss(losses, cfg)
    loss.backward()
    assign, rows = matcher_rows(out, targets, cfg.costs)
    grads = {k: to_numpy(p.grad) if p.grad is not None else np.zeros(p.shape, np.float32)
             for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    scalars = {k: float(v.detach()) for k, v in losses.items()}
    scalars["loss"] = float(loss.detach())
    return step_record(scalars, grads, assign, rows, sample_keys)


def port_inference(model, text_encoder_type: str, inf: Mapping) -> tuple:
    """The port's side of an inference golden (`inf`: its meta.json entry)
    on the model's device: (soc_record of the clip forward, the
    InferenceEngine's masks from infer_videos). Raises if
    the port's tokenizer disagrees with the ids JAX ran."""
    from .inference import InferenceEngine

    T, H, W, _ = inf["video"]
    video = golden_videos(1, T, H, W, inf["video_seed"])[0]
    eng = inf["engine"]
    engine = InferenceEngine(model, text_encoder_type=text_encoder_type,
                             text_bucket=eng["text_bucket"], time_buckets=eng["time_buckets"],
                             size_buckets=[tuple(s) for s in eng["size_buckets"]],
                             device=next(model.parameters()).device)
    ids, msk = engine.tokenizer([inf["expression"]])
    if ids.tolist() != inf["text_ids"] or msk.tolist() != inf["text_mask"]:
        raise GoldenMismatch(f"token ids {ids.tolist()} against JAX's {inf['text_ids']}")
    soc = port_clip_record(model, video, ids, msk)
    (masks,), = list(engine.infer_videos([dict(frames=video, texts=[inf["expression"]])]))
    return soc, masks
