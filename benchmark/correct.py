"""The comparisons that decide `correct`: what the timed path produced
against the plain reference (float32, TF32 off), as numbers each held to a
limit in the cell's workload file. Other numbers are reported beside them.

For each expression the program's mask is counted against every query's
thresholded reference mask. Compared:

- `mask_mismatch_vs_bf16`: the mismatched pixels at the query the mask agrees
  with most, over those of the reference computed in bfloat16 (the
  configuration's precision) at the same query;
- `query_gap_vs_bf16`: the choice. The query the program chose is the
  highest-scoring one whose mask the program's agrees with as well as with
  the best, to a count's noise; how far its float32 score lies below
  float32's best, over how far a choice in bfloat16 can fall: bfloat16's own
  choice's gap plus twice its largest score error.

Reported: the chosen query's score gap (`query_score_gap`), the largest
|reference logit| at a mismatched pixel over the largest of the mask
(`mask_logit_gap`), the mismatched shares.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

PIXEL_ALLOWANCE = 1e-5
SCORE_FLOOR = 1e-7


def count_noise(n: int, pixels: int) -> float:
    """What a count of n flipped pixels may differ by: three standard
    deviations of a count's noise and a hundred-thousandth of the pixels
    (where bfloat16 flips almost none, the program's own rounding still flips
    a few hundred of tens of millions)."""
    return 3 * math.sqrt(n) + PIXEL_ALLOWANCE * pixels


def engine_gaps(masks: Sequence[np.ndarray], ref: Sequence[Mapping], t: int,
                low: Optional[Sequence[Mapping]] = None) -> Dict:
    """masks: the program's (t, oh, ow) uint8 masks per expression; ref (and
    low, the reference in bfloat16): per expression {"scores", "logits"}.
    Returns the worst gaps over the expressions, the mismatched share of
    their pixels, the query each expression's mask agrees with most, and per
    expression (chosen, float32's best, bfloat16's best, gap, bfloat16's own
    gap, bfloat16's score error)."""
    out = {"query_score_gap": 0.0, "mask_logit_gap": 0.0, "queries": [], "choices": []}
    if low is not None:
        out["query_gap_vs_bf16"] = 0.0
    mismatch = pixels = 0
    for k, (got, r) in enumerate(zip(masks, ref)):
        scores = np.asarray(r["scores"], np.float64) / t
        order = [int(q) for q in np.argsort(-scores, kind="stable")]
        g = best = None
        counts = []
        for q in order:
            logits = r["logits"](q)
            if g is None:
                g = torch.from_numpy(np.ascontiguousarray(got)).to(logits.device).bool()
            wrong = (logits > 0) != g
            counts.append(int(wrong.sum()))
            if best is None or counts[-1] < best[0]:
                best = (counts[-1], q, wrong, logits)
        n, q, wrong, logits = best
        slack = n + count_noise(n, g.numel())
        chosen = next(o for o, c in zip(order, counts) if c <= slack)
        gap = float(scores.max() - scores[chosen])
        out["queries"].append(q)
        out["query_score_gap"] = max(out["query_score_gap"], gap)
        if low is not None:
            s16 = np.asarray(low[k]["scores"], np.float64) / t
            noise = float(np.abs(s16 - scores).max())
            own = float(scores.max() - scores[int(np.argmax(s16))])
            out["query_gap_vs_bf16"] = max(out["query_gap_vs_bf16"],
                                           gap / max(own + 2 * noise, SCORE_FLOOR))
            out["choices"].append((chosen, order[0], int(np.argmax(s16)), gap, own, noise))
        if n:
            mag = logits.abs()
            out["mask_logit_gap"] = max(out["mask_logit_gap"],
                                        float(mag[wrong].max() / mag.max()))
        mismatch += n
        pixels += g.numel()
    out["mask_mismatch_share"] = mismatch / max(pixels, 1)
    return out


def bf16_mismatches(ref: Mapping, bf16: Mapping, q: int) -> int:
    """Pixels where query q's mask computed in bfloat16 differs from float32's."""
    return int(((ref["logits"](q) > 0) != (bf16["logits"](q) > 0)).sum())


def engine_numbers(got: Mapping[int, Sequence[np.ndarray]], refs: Mapping[int, Sequence[Mapping]],
                   bf16: Mapping[int, Sequence[Mapping]], lengths: Mapping[int, int],
                   choices: Optional[List] = None) -> Dict[str, float]:
    """The checked videos' numbers: the worst of each engine gap over the
    videos, the mismatched share of all their pixels, and the mismatches over
    those of the reference computed in bfloat16 at the same queries, so a
    seed or a query whose masks have many pixels near the threshold does not
    read as a fault: n / (n_bf16 + count_noise(n_bf16, pixels)). `bf16` holds
    that reference's outputs (as `refs`); `choices`, where given, gets each
    expression's choice as engine_gaps gives it."""
    out: Dict[str, float] = {}
    n_got = n_bf16 = pixels = 0
    for i in got:
        gaps = engine_gaps(got[i], refs[i], lengths[i], bf16[i])
        queries = gaps.pop("queries")
        if choices is not None:
            choices.extend(gaps["choices"])
        del gaps["choices"]
        pixels += sum(m.size for m in got[i])
        n_got += round(gaps["mask_mismatch_share"] * sum(m.size for m in got[i]))
        n_bf16 += sum(bf16_mismatches(r, b, q) for r, b, q in zip(refs[i], bf16[i], queries))
        for k, v in gaps.items():
            out[k] = max(out.get(k, 0.0), v)
    out.update(mask_mismatch_share=n_got / max(pixels, 1),
               bf16_mismatch_share=n_bf16 / max(pixels, 1),
               mask_mismatch_vs_bf16=n_got / (n_bf16 + count_noise(n_bf16, pixels)),
               videos_checked=float(len(got)))
    return out


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]) -> Dict[str, Dict]:
    """{name: {value, limit}} of every limited number, in the limits' order."""
    return {k: {"value": float(numbers[k]), "limit": float(v)} for k, v in limits.items()}


def passed(checks: Mapping[str, Mapping]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
