"""Hungarian matcher (torch twin of neurips2023_soc_tpu/losses/matcher.py).

Costs are computed on the step's device over static padded instance slots,
and the assignment is solved there too by an exact shortest-augmenting-path
LAP solver (`lsa_on_device`, the algorithm of scipy's
linear_sum_assignment). Nothing crosses to the host: the solver's searches,
which JAX runs as while_loops, run here for their bounded number of rounds
with finished batch entries masked, so no step waits on a device-to-host read.

Static target layout (data/collate.py):
  masks:    (T, B, N, H, W)  binary, model-input resolution
  boxes:    (T, B, N, 4)     normalized cxcywh (zeros when invisible)
  labels:   (B, N)           int32 class ids
  inst_valid: (B, N)         bool — slot holds a real instance
  is_ref_inst_visible: (T, B, N) bool — per-frame visibility
  referred_instance_idx: (B,) int32

The assignment is (B, N) int64: the query matched to each instance slot, -1
on invalid slots.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..utils.boxes import box_cxcywh_to_xyxy, generalized_box_iou

BIG = 1e8
_UNVISITED = 1e30


@dataclasses.dataclass(frozen=True)
class MatchCosts:
    cost_con: float = 0.0
    cost_cls: float = 2.0
    cost_dice: float = 5.0
    cost_box: float = 2.0
    cost_giou: float = 2.0
    num_classes: int = 1


def _focal_pos_neg(p: torch.Tensor, alpha: float = 0.25, gamma: float = 2.0):
    eps = 1e-8
    neg = (1 - alpha) * (p ** gamma) * (-torch.log(1 - p + eps))
    pos = alpha * ((1 - p) ** gamma) * (-torch.log(p + eps))
    return pos, neg


def compute_cost_matrix(outputs: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor],
                        upsampled_mask_logits: torch.Tensor,
                        costs: MatchCosts) -> torch.Tensor:
    """(B, Nq, N) float32 query-by-instance costs, BIG on invalid instance
    columns. upsampled_mask_logits: (T, B, Nq, H, W) at the target masks'
    resolution."""
    pred_cls = torch.sigmoid(outputs["pred_cls"].float())  # (T, B, Nq, K)
    T, B, Nq, K = pred_cls.shape
    vis = targets["is_ref_inst_visible"].float()  # (T, B, N)
    valid = targets["inst_valid"].bool()  # (B, N)
    N = valid.shape[1]
    C = torch.zeros(B, Nq, N, dtype=torch.float32, device=pred_cls.device)

    if costs.cost_cls > 0:
        pos, neg = _focal_pos_neg(pred_cls)
        if costs.num_classes == 1:
            diff = (pos - neg)[..., 0][..., None].expand(T, B, Nq, N)
        else:
            lbl = targets["labels"].long()  # (B, N)
            idx = lbl[None, :, None, :].expand(T, B, Nq, N)
            diff = torch.gather(pos - neg, 3, idx)  # (T, B, Nq, N)
        # average over each instance's visible frames
        w = vis[:, :, None, :]  # (T, B, 1, N)
        denom = w.sum(0).clamp(min=1.0)
        C = C + costs.cost_cls * ((diff * w).sum(0) / denom)

    if costs.cost_dice > 0:
        pr = torch.sigmoid(upsampled_mask_logits.float()).reshape(T, B, Nq, -1)
        tg = targets["masks"].float().reshape(T, B, N, -1)
        inter = torch.einsum("tbqp,tbnp->tbqn", pr, tg)
        denom = pr.sum(-1)[..., None] + tg.sum(-1)[:, :, None, :]
        coef = (2 * inter + 1.0) / (denom + 1.0)
        C = C - costs.cost_dice * coef.mean(0)

    if costs.cost_box > 0:
        pb = outputs["pred_boxes"].float()  # (T, B, Nq, 4)
        tb = targets["boxes"].float()  # (T, B, N, 4)
        l1 = (pb[:, :, :, None, :] - tb[:, :, None, :, :]).abs().sum(-1)
        C = C + costs.cost_box * l1.mean(0)

    if costs.cost_giou > 0:
        pb = box_cxcywh_to_xyxy(outputs["pred_boxes"].float())
        tb = box_cxcywh_to_xyxy(targets["boxes"].float())
        giou = generalized_box_iou(pb.reshape(T * B, Nq, 4),
                                   tb.reshape(T * B, N, 4)).reshape(T, B, Nq, N)
        C = C - costs.cost_giou * giou.mean(0)

    if costs.cost_con > 0:
        logit = outputs["pred_logit"].float()  # (B, Nq, Cd)
        txt = outputs["text_sentence_feature"].float()  # (B, Cd)
        con = torch.softmax(torch.einsum("bqc,bc->bq", logit, txt), -1)
        C = C - costs.cost_con * con[..., None].expand(B, Nq, N)

    return torch.where(valid[:, None, :], C, torch.full_like(C, BIG))


def _lsa(C: torch.Tensor) -> torch.Tensor:
    """Exact rectangular linear sum assignment, batched, on C's device.

    C: (B, N, M) float32 with N <= M rows to assign. Returns (B, N) int64, the
    column of each row. Shortest augmenting paths (Crouse 2016), as JAX's
    `_lsa_single`: the same updates, the same tie-breaks (among equal minima
    an unassigned column, else the first). Row r's search marks one new
    column per round and ends on a free one within r + 1 rounds; its
    augmenting path has at most r + 1 edges. Each loop runs those rounds, a
    batch entry that has finished early keeping its state."""
    B, N, M = C.shape
    dev = C.device
    bidx = torch.arange(B, device=dev)
    rows = torch.arange(N, device=dev)
    u = torch.zeros(B, N, device=dev)
    v = torch.zeros(B, M, device=dev)
    col4row = torch.full((B, N), -1, dtype=torch.long, device=dev)
    row4col = torch.full((B, M), -1, dtype=torch.long, device=dev)
    for cur_row in range(N):
        # Dijkstra over alternating paths from cur_row
        sink = torch.full((B,), -1, dtype=torch.long, device=dev)
        i = torch.full((B,), cur_row, dtype=torch.long, device=dev)
        min_val = torch.zeros(B, device=dev)
        SR = torch.zeros(B, N, dtype=torch.bool, device=dev)
        SC = torch.zeros(B, M, dtype=torch.bool, device=dev)
        spc = torch.full((B, M), _UNVISITED, device=dev)
        path = torch.zeros(B, M, dtype=torch.long, device=dev)
        for _ in range(min(M, cur_row + 1)):
            active = sink == -1  # (B,)
            SR = SR | ((rows[None] == i[:, None]) & active[:, None])
            cand = min_val[:, None] + C[bidx, i] - u[bidx, i][:, None] - v
            better = (cand < spc) & ~SC & active[:, None]
            spc = torch.where(better, cand, spc)
            path = torch.where(better, i[:, None], path)
            masked = torch.where(SC, torch.full_like(spc, _UNVISITED), spc)
            lowest = masked.min(-1).values
            prefer = (masked <= lowest[:, None]) & (row4col == -1)
            j = torch.where(prefer.any(-1), prefer.int().argmax(-1), masked.argmin(-1))
            SC = SC | ((torch.arange(M, device=dev)[None] == j[:, None]) & active[:, None])
            owner = row4col[bidx, j]
            hit_free = owner == -1
            min_val = torch.where(active, lowest, min_val)
            i = torch.where(active & ~hit_free, owner, i)
            sink = torch.where(active & hit_free, j, sink)

        # dual updates
        u[:, cur_row] += min_val
        spc_at_row_col = torch.gather(spc, 1, col4row.clamp(min=0))  # (B, N)
        upd = SR & (rows[None] != cur_row)
        u = torch.where(upd, u + min_val[:, None] - spc_at_row_col, u)
        v = torch.where(SC, v - (min_val[:, None] - spc), v)

        # augment along the path found
        s = sink
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        for _ in range(cur_row + 1):
            go = ~done
            i = path[bidx, s.clamp(min=0)]
            nxt = col4row[bidx, i]
            row4col = torch.where(
                go[:, None] & (torch.arange(M, device=dev)[None] == s[:, None]),
                i[:, None], row4col)
            col4row = torch.where(go[:, None] & (rows[None] == i[:, None]),
                                  s[:, None], col4row)
            done = done | (go & (i == cur_row))
            s = torch.where(go, nxt, s)
    return col4row


@torch.no_grad()
def lsa_on_device(C: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Batched exact assignment. C: (B, Nq, N) query-by-instance costs;
    valid: (B, N). Returns (B, N) int64 query per instance slot, -1 on invalid
    slots.

    Invalid columns are zeroed, not BIG, before solving: a per-column constant
    does not change the assignment, and 1e8-scale entries would wreck the
    float32 dual updates (JAX matcher.py:209-217)."""
    valid = valid.bool()
    C = torch.nan_to_num(C.float()).clamp(-1e6, 1e6)
    C = torch.where(valid[:, None, :], C, torch.zeros_like(C))
    B, Nq, N = C.shape
    if N <= Nq:
        # rows must be the small side: instances assign queries
        out = _lsa(C.transpose(1, 2))
        return torch.where(valid, out, torch.full_like(out, -1))
    # more instance slots than queries: queries assign instances and the
    # result is inverted; the unmatched instances stay -1 (scipy's rectangular
    # semantics). Invalid columns must then be strictly worse than any valid
    # one, by a moderate margin (a 1e8 constant would wreck the dual updates).
    big = 2.0 * C.abs().max() + 1.0
    Cq = torch.where(valid[:, None, :], C, big)
    inst4q = _lsa(Cq)  # (B, Nq)
    out = torch.full((B, N), -1, dtype=torch.long, device=C.device)
    q = torch.arange(Nq, device=C.device)[None].expand(B, Nq)
    out = out.scatter(1, inst4q, q)
    return torch.where(valid, out, torch.full_like(out, -1))


@torch.no_grad()
def hungarian_match(outputs: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor],
                    upsampled_mask_logits: torch.Tensor,
                    costs: MatchCosts) -> torch.Tensor:
    """(B, N) query index per instance slot, -1 on invalid; no gradient."""
    C = compute_cost_matrix(outputs, targets, upsampled_mask_logits, costs)
    valid = targets["inst_valid"].bool()
    if C.shape[2] == 1:
        # one referred instance per sample (every reference training
        # workload): the assignment is an exact argmin
        q = C[..., 0].argmin(-1)
        return torch.where(valid[:, 0], q, torch.full_like(q, -1))[:, None]
    return lsa_on_device(C, valid)
