"""The port's ResNet-50 backbone (models/resnet.py) against the JAX
package's, on the CPU in float32: the backbone at layer_sizes (1, 1, 1, 1)
on 2 frames of 64 x 96 through convert.py (rtol = atol = 1e-4), FrozenBN
against its closed form, the tiny SOC with `backbone: resnet50` (full
ResNet-50 depth, T = 2) against JAX's SOC forward after a strict
load_jax_params (1e-4 of each output's scale), the optimizer labels (212
FrozenBN tensors `frozen`, as JAX's `_label_tree`), and one clipped update
on a ResNet loss equal to optax's chain: the FrozenBN gradients enter the
clip norm and get no update."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neurips2023_soc_tpu.models.resnet import ResNet50Backbone as JaxResNet
from neurips2023_soc_tpu.models.soc import SOC as JaxSOC
from neurips2023_soc_tpu.training import optim as jax_optim
from neurips2023_soc_torch.convert import load_jax_params, state_dict_from_jax
from neurips2023_soc_torch.models.common import init_weights
from neurips2023_soc_torch.models.resnet import FrozenBN, ResNet50Backbone
from neurips2023_soc_torch.models.soc import SOC, _BackboneBody
from neurips2023_soc_torch.training.optim import build_optimizer, global_norm, param_label
from torch_port_helpers import jax_params_from_torch
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)

SMALL = (1, 1, 1, 1)
N_FROZEN_BN = 4 * (1 + 3 * 16 + 4)  # stem bn1, 3 per bottleneck, 4 downsample bns


class _Backbone(torch.nn.Module):
    """A backbone under SOC's `backbone.0.body.` keys."""

    def __init__(self, body):
        super().__init__()
        self.backbone = torch.nn.ModuleList([_BackboneBody(body)])


def _video(seed=0):
    return np.random.RandomState(seed).randn(1, 2, 64, 96, 3).astype(np.float32)


@pytest.fixture(scope="module")
def small():
    """JAX's (1, 1, 1, 1) ResNet initialized by flax, its parameters, and
    their state_dict through convert.state_dict_from_jax."""
    jm = JaxResNet(layer_sizes=SMALL)
    params = jax.tree_util.tree_map(np.asarray,
                                    jax.jit(jm.init)(jax.random.PRNGKey(0), _video())["params"])
    # the stats of an ImageNet-trained table rather than the init's 1 / 0
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (np.abs(v + 0.3 * rng.randn(*v.shape)) + 0.2).astype(np.float32)
        if "frozen_bn_var" in str(path) or "frozen_bn_scale" in str(path)
        else (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        if "frozen_bn" in str(path) else v, params)
    return jm, params, state_dict_from_jax({"backbone": params})


def _port(sd):
    tm = _Backbone(ResNet50Backbone(layer_sizes=SMALL))
    tm.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return tm


def test_resnet_backbone_vs_jax(small):
    jm, params, sd = small
    want = jax.jit(jm.apply)({"params": params}, _video())
    got = _port(sd).backbone[0].body(torch.from_numpy(_video()))
    assert [tuple(g.shape) for g in got] == [
        (2, 16, 24, 256), (2, 8, 12, 512), (2, 4, 6, 1024), (2, 2, 3, 2048)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_frozen_bn_closed_form():
    """tests/test_model.py's FrozenBN case, on (N, C, H, W) maps."""
    bn = FrozenBN(3)
    vals = {"weight": [2.0, 1.0, 0.5], "bias": [0.1, -0.2, 0.0],
            "running_mean": [0.5, 0.0, -1.0], "running_var": [4.0, 1.0, 0.25]}
    bn.load_state_dict({k: torch.tensor(v) for k, v in vals.items()})
    xb = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    got = bn(torch.from_numpy(xb)[..., None, None])[..., 0, 0].detach().numpy()
    p = {k: np.float32(v) for k, v in vals.items()}
    want = (xb - p["running_mean"]) / np.sqrt(p["running_var"] + 1e-5) * p["weight"] + p["bias"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_soc_resnet50_forward_vs_jax():
    """The tiny SOC with the full ResNet-50 backbone, batch 2 with padding:
    JAX's parameter tree (filled with the port's init) loads strictly and
    every output matches at 1e-4 of its scale."""
    kw = dict(backbone_name="resnet50", d_model=64, num_queries=5, dim_feedforward=128,
              enc_layers=1, dec_layers=2, voc_enc_layers=1, voc_dec_layers=1,
              text_encoder_type="roberta-tiny")
    rng = np.random.RandomState(0)
    T, B, H, W = 2, 2, 64, 96
    px = rng.randn(T, B, H, W, 3).astype(np.float32)
    pad = np.zeros((T, B, H, W), bool)
    pad[:, 1, 56:] = True
    px[pad] = 0.0
    ids = rng.randint(3, 1000, size=(B, 8)).astype(np.int32)
    msk = np.ones((B, 8), np.int32)
    msk[1, 5:] = 0
    jm = JaxSOC(dropout=0.0, **kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), px, pad, ids, msk)["params"]
    tm = init_weights(SOC(**kw), torch.Generator().manual_seed(0))
    params = {"params": jax_params_from_torch(tm, shapes)}
    tm = load_jax_params(SOC(**kw), params).eval()  # strict
    assert "backbone.0.body.layer4.2.bn3.running_var" in dict(tm.named_parameters())
    want = jax.jit(jm.apply)(params, px, pad, ids, msk)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (px, pad, ids, msk)))
    assert got["pred_masks"].shape == (1, T, B, 5, 16, 24)
    for k in ("pred_masks", "pred_cls", "pred_boxes", "pred_logit", "text_sentence_feature"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(np.abs(w).max())), err_msg=k)


def test_frozen_bn_labels_vs_jax():
    """The full ResNet-50's 212 FrozenBN tensors are `frozen` in the port's
    optimizer and in JAX's `_label_tree`; its convolutions are `backbone`."""
    labels = {n: param_label(n, freeze_text=True)
              for n, _ in _Backbone(ResNet50Backbone()).named_parameters()}
    frozen = sorted(n for n, lab in labels.items() if lab == "frozen")
    assert len(frozen) == N_FROZEN_BN
    assert {lab for n, lab in labels.items() if n not in frozen} == {"backbone"}
    shapes = jax.eval_shape(JaxResNet().init, jax.random.PRNGKey(0), _video())
    jlabels = jax.tree_util.tree_leaves(jax_optim._label_tree(
        {"params": {"backbone": shapes["params"]}}, freeze_text=True))
    assert sorted(jlabels) == sorted(labels.values())


def test_clipped_update_with_frozen_bn_vs_optax(small):
    """One update of the (1, 1, 1, 1) ResNet on a loss of its four maps:
    the port's gradients match JAX's, FrozenBN's are non-zero and carry a
    visible share of the clip norm, and the port's clipped AdamW on them
    equals optax's chain (clip_by_global_norm, then the frozen mask) at
    1e-6: the FrozenBN tensors stay bit-unchanged."""
    jm, params, sd = small
    tm = _port(sd)
    x = _video(2)
    weights = [np.random.RandomState(3 + i).randn(*s).astype(np.float32)
               for i, s in enumerate([(2, 16, 24, 256), (2, 8, 12, 512), (2, 4, 6, 1024),
                                      (2, 2, 3, 2048)])]

    def jax_loss(p):
        outs = jm.apply({"params": p["params"]["backbone"]}, x)
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights)) / 100.0

    tree = {"params": {"backbone": params}}
    jgrads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(jax_loss))(tree))
    outs = tm.backbone[0].body(torch.from_numpy(x))
    (sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, weights)) / 100.0).backward()
    want = state_dict_from_jax(jgrads)
    named = dict(tm.named_parameters())
    for k, w in want.items():
        np.testing.assert_allclose(named[k].grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(np.abs(w).max())), err_msg=k)
    bn = [n for n in named if param_label(n, True) == "frozen"]
    assert all(named[n].grad.abs().max() > 0 for n in bn)
    norm_all = float(global_norm(p.grad for p in named.values()))
    norm_conv = float(global_norm(named[n].grad for n in named if n not in bn))
    assert norm_all > 0.1 and norm_all - norm_conv > 1e-3 * norm_all

    kw = dict(lr=1e-2, lr_backbone=3e-3, text_encoder_lr=5e-3, weight_decay=0.05,
              clip_max_norm=0.1, freeze_text=True)
    # the same gradients on both sides: the port's, in JAX's layout
    grads = {"params": {"backbone": jax_params_from_torch_grads(tm, params)}}
    tx = jax_optim.build_optimizer(tree, **kw)
    new = state_dict_from_jax(jax.jit(
        lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(grads, tree))
    before = {n: p.detach().clone() for n, p in named.items()}
    opt = build_optimizer(tm, **kw)
    assert opt.apply_gradients()
    for n, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), new[n], rtol=1e-6, atol=1e-6, err_msg=n)
        if n in bn:
            assert torch.equal(p, before[n]), n
        else:
            assert not torch.equal(p, before[n]), n


def jax_params_from_torch_grads(tm, params):
    """The port's gradients as a JAX tree shaped like `params`."""
    grads = _Backbone(ResNet50Backbone(layer_sizes=SMALL))
    grads.load_state_dict({n: p.grad for n, p in tm.named_parameters()}, strict=True)
    shapes = jax.tree_util.tree_map(lambda v: jax.ShapeDtypeStruct(v.shape, v.dtype), params)
    return jax_params_from_torch(grads, {"backbone": shapes})["backbone"]
