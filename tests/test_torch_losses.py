"""The port's losses (neurips2023_soc_torch.losses) against the JAX package's
on the CPU in float32: dice and focal losses, the matching cost matrix and
the whole criterion's loss dict at rtol = atol = 1e-5, and the on-device LAP
solver against scipy's linear_sum_assignment on the cases of
tests/test_matcher_exact.py (random, ties, more instances than queries)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from neurips2023_soc_tpu import losses as jl
from neurips2023_soc_tpu.losses.matcher import lsa_on_device as jax_lsa
from neurips2023_soc_torch import losses as tl
from neurips2023_soc_torch.losses.matcher import BIG

TOL = dict(rtol=1e-5, atol=1e-5)


def _outputs_targets(seed, Le=2, T=3, B=2, Nq=5, N=1, K=1, h=6, w=8, C=16):
    """Random SOC-shaped outputs (stacked over Le layers) and collated
    targets at 4x the mask resolution."""
    rng = np.random.RandomState(seed)
    H, W = 4 * h, 4 * w
    out = {
        "pred_masks": (3 * rng.randn(Le, T, B, Nq, h, w)).astype(np.float32),
        "pred_cls": rng.randn(Le, T, B, Nq, K).astype(np.float32),
        "pred_boxes": rng.uniform(0.1, 0.9, (Le, T, B, Nq, 4)).astype(np.float32),
        "pred_logit": rng.randn(Le, B, Nq, C).astype(np.float32),
        "text_sentence_feature": rng.randn(B, C).astype(np.float32),
    }
    valid = np.ones((B, N), bool)
    if N > 1:
        valid[1, -1] = False
    vis = rng.rand(T, B, N) < 0.8
    tgt = {
        "masks": (rng.rand(T, B, N, H, W) < 0.3).astype(np.float32),
        "boxes": np.where(vis[..., None], rng.uniform(0.2, 0.8, (T, B, N, 4)),
                          0.0).astype(np.float32),
        "labels": rng.randint(0, K, (B, N)).astype(np.int32),
        "inst_valid": valid,
        "is_ref_inst_visible": vis,
        "referred_instance_idx": rng.randint(0, N if N == 1 else N - 1, (B,)).astype(np.int32),
    }
    return out, tgt


def _torch(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _configs(K):
    costs = dict(cost_con=0.5, cost_cls=2.0, cost_dice=5.0, cost_box=2.0, cost_giou=2.0,
                 num_classes=K)
    crit = dict(num_classes=K, use_vl_loss=True, aux_loss=True, weight_con=1.0)
    return (jl.CriterionConfig(costs=jl.MatchCosts(**costs), **crit),
            tl.CriterionConfig(costs=tl.MatchCosts(**costs), **crit))


def test_mask_losses_vs_jax():
    rng = np.random.RandomState(0)
    x = (10 * rng.randn(6, 50)).astype(np.float32)
    t = (rng.rand(6, 50) < 0.4).astype(np.float32)
    w = np.array([1, 1, 0, 1, 0, 1], np.float32)
    for name in ("dice_loss", "sigmoid_focal_loss"):
        for weight in (None, w):
            want = getattr(jl, name)(x, t, 4.0, weight=weight)
            got = getattr(tl, name)(torch.from_numpy(x), torch.from_numpy(t), 4.0,
                                    weight=None if weight is None else torch.from_numpy(w))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **TOL)


@pytest.mark.parametrize("N,K", [(1, 1), (3, 1), (3, 2)])
def test_cost_matrix_vs_jax(N, K):
    out, tgt = _outputs_targets(1, N=N, K=K)
    layer = {k: v[0] if k != "text_sentence_feature" else v for k, v in out.items()}
    up = np.repeat(np.repeat(layer["pred_masks"], 4, -2), 4, -1)
    jcfg, tcfg = _configs(K)
    want = jax.jit(jl.compute_cost_matrix, static_argnums=3)(layer, tgt, up, jcfg.costs)
    got = tl.compute_cost_matrix(_torch(layer), _torch(tgt), torch.from_numpy(up), tcfg.costs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("N,K", [(1, 1), (3, 1), (3, 2)])
def test_criterion_loss_dict_vs_jax(N, K):
    """Every loss term of every layer (aux losses `_i` included) and the
    weighted total; N = 1 matches by argmin, N = 3 by the LAP solver."""
    out, tgt = _outputs_targets(2, N=N, K=K)
    jcfg, tcfg = _configs(K)

    @jax.jit
    def jax_losses(out, tgt):
        d = jl.compute_criterion(out, tgt, jcfg)
        return d, jl.total_loss(d, jcfg)

    want, want_total = jax_losses(out, tgt)
    got = tl.compute_criterion(_torch(out), _torch(tgt), tcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    np.testing.assert_allclose(tl.total_loss(got, tcfg).numpy(), np.asarray(want_total),
                               **TOL)


def test_criterion_gradient_reaches_only_the_matched_queries():
    """Gradients flow through the matched queries' masks and boxes; the
    matching itself carries none."""
    out, tgt = _outputs_targets(3)
    _, tcfg = _configs(1)
    tout = {k: v.requires_grad_() for k, v in _torch(out).items()}
    losses = tl.compute_criterion(tout, _torch(tgt), dataclasses.replace(tcfg, aux_loss=False))
    tl.total_loss(losses, tcfg).backward()
    g = tout["pred_masks"].grad[-1]  # (T, B, Nq, h, w), last layer
    touched = (g.abs().sum((0, 3, 4)) > 0)  # (B, Nq)
    assert touched.sum(1).tolist() == [1, 1]
    assert tout["pred_masks"].grad[0].abs().sum() == 0  # no aux loss on layer 0


def _check_lsa(C, valid):
    """The port's assignment is injective, -1 on invalid slots, covers
    min(Nq, valid) instances and costs what scipy's optimum costs."""
    out = tl.lsa_on_device(torch.from_numpy(C), torch.from_numpy(valid)).numpy()
    B, Nq, N = C.shape
    for b in range(B):
        q = out[b]
        assert (q[~valid[b]] == -1).all()
        matched = np.nonzero(q >= 0)[0]
        assert len(set(q[matched].tolist())) == len(matched), "assignment not injective"
        assert len(matched) == min(Nq, int(valid[b].sum()))
        cols = np.nonzero(valid[b])[0]
        if len(cols) == 0:
            continue
        rows, col_idx = linear_sum_assignment(C[b][:, cols])
        ref = C[b][rows, cols[col_idx]].sum()
        mine = sum(C[b][q[j], j] for j in matched)
        assert np.isclose(mine, ref, rtol=1e-5, atol=1e-4), f"suboptimal at b={b}"
    return out


@pytest.mark.parametrize("Nq,N", [(20, 1), (20, 3), (20, 8), (20, 20), (5, 5),
                                  (5, 9), (3, 12), (8, 20)])
def test_lsa_random_vs_scipy(Nq, N):
    rng = np.random.RandomState(Nq * 100 + N)
    C = (rng.randn(32, Nq, N) * 10.0).astype(np.float32)
    valid = rng.rand(32, N) < 0.8
    valid[:, 0] = True
    if N <= Nq:
        C = np.where(valid[:, None, :], C, BIG).astype(np.float32)
    _check_lsa(C, valid)


def test_lsa_ties_and_structured_vs_scipy_and_jax():
    """Integer costs in a tiny range (massive ties), an all-zero matrix and
    an anti-greedy one; on ties the port picks the JAX solver's indices."""
    rng = np.random.RandomState(0)
    C = rng.randint(0, 3, size=(32, 12, 7)).astype(np.float32)
    valid = np.ones((32, 7), bool)
    got = _check_lsa(C, valid)
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jax_lsa)(C, valid)))
    _check_lsa(np.zeros((1, 9, 4), np.float32), np.ones((1, 4), bool))
    C2 = np.full((1, 3, 3), 10.0, np.float32)
    C2[0, 0, 0], C2[0, 0, 1], C2[0, 1, 0], C2[0, 1, 1], C2[0, 2, 2] = 0.0, 0.1, 0.1, 100.0, 0.0
    _check_lsa(C2, np.ones((1, 3), bool))


def test_hungarian_single_instance_is_argmin():
    out, tgt = _outputs_targets(4)
    layer = {k: v[0] if k != "text_sentence_feature" else v for k, v in out.items()}
    layer, tgt_t = _torch(layer), _torch(tgt)
    up = layer["pred_masks"].repeat_interleave(4, -2).repeat_interleave(4, -1)
    _, tcfg = _configs(1)
    C = tl.compute_cost_matrix(layer, tgt_t, up, tcfg.costs)
    got = tl.hungarian_match(layer, tgt_t, up, tcfg.costs)
    assert got.shape == (2, 1)
    np.testing.assert_array_equal(got[:, 0].numpy(), C[..., 0].argmin(-1).numpy())
