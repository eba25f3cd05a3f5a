"""Helpers for the parity tests of the PyTorch port against the JAX package:
initialize a flax module from numpy inputs, carry its parameters into the
port's twin, and compare outputs as numpy arrays."""
import json
import os
import re
from collections.abc import Mapping

import jax
import numpy as np
import pytest
import torch

from neurips2023_soc_torch.convert import INVERSE_TRANSFORMS, flax_to_torch

@pytest.fixture(autouse=True, scope="module")
def torch_threads_per_worker():
    """Under pytest-xdist, torch's intra-op pool gets the worker's share of
    the cores (cpu_count // workers, at least 1) while a module's tests run:
    every worker's default pool of cpu_count threads oversubscribes the CPU,
    and the waiting threads slowed the port's torch-heavy tests 5-10 fold.
    A run without workers keeps the default. Test modules import this
    fixture, which makes it autouse for them."""
    share = worker_share_of_cores()
    if share is None:
        yield
        return
    saved = torch.get_num_threads()
    torch.set_num_threads(share)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def worker_share_of_cores():
    """cpu_count // xdist workers (at least 1), or None outside xdist."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers <= 1:
        return None
    return max(1, (os.cpu_count() or 1) // workers)


# torch layout -> flax layout: the inverses of convert.INVERSE_TRANSFORMS
TRANSFORMS = {
    "linear": lambda x: np.ascontiguousarray(x.T),
    "conv": lambda x: np.ascontiguousarray(np.transpose(x, (2, 3, 1, 0))),
    "conv3d": lambda x: np.ascontiguousarray(np.transpose(x, (2, 3, 4, 1, 0))),
    "copy": lambda x: x,
}


def run_jax(fn, *args, **kwargs):
    """fn(*args, **kwargs) under one jax.jit (one compile instead of one per
    op); tuples, Python scalars, strings and None stay static. Returns numpy."""
    def static(a):
        return a is None or isinstance(a, (tuple, int, float, bool, str))

    pos = [i for i, a in enumerate(args) if not static(a)]
    kws = [k for k, a in kwargs.items() if not static(a)]

    def inner(dyn_args, dyn_kwargs):
        a = list(args)
        for i, v in zip(pos, dyn_args):
            a[i] = v
        return fn(*a, **{**kwargs, **dyn_kwargs})

    out = jax.jit(inner)([args[i] for i in pos], {k: kwargs[k] for k in kws})
    return jax.tree_util.tree_map(np.asarray, out)


def init_jax(module, *args, seed=0, **kwargs):
    """flax init -> parameter tree of numpy arrays (no 'params' wrapper)."""
    key = jax.random.PRNGKey(seed)
    return run_jax(lambda *a, **k: module.init(key, *a, **k), *args, **kwargs)["params"]


def apply_jax(module, params, *args, **kwargs):
    return run_jax(lambda p, *a, **k: module.apply({"params": p}, *a, **k),
                   params, *args, **kwargs)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "in_proj_kernel": "in_proj_weight"}


def generic_state_dict(tree):
    """State dict for a port module whose attribute names equal the flax
    module's (the shared layers): Dense/Conv kernels transposed to torch's
    layout, norm scales to weights, `layers_i` to `layers.i`."""
    sd = {}
    for path, leaf in _leaves(tree):
        mods = [re.sub(r"^layers_(\d+)$", r"layers.\1", p) for p in path[:-1]]
        name = path[-1]
        if name in ("kernel", "in_proj_kernel"):
            kind = {2: "linear", 4: "conv", 5: "conv3d"}[leaf.ndim]
            leaf = INVERSE_TRANSFORMS[kind](leaf)
        sd[".".join(mods + [_LEAF.get(name, name)])] = leaf
    return sd


def soc_state_dict(tree, flax_prefix, torch_prefix):
    """State dict of one SOC submodule through the port's own mapping
    (convert.flax_to_torch): keys under `torch_prefix` lose it, the others
    (the transformer's box heads, `bbox_embed.*`) are kept as they are."""
    sd = {}
    for path, leaf in _leaves(tree):
        key, kind = flax_to_torch((flax_prefix,) + path)
        if key.startswith(torch_prefix):
            key = key[len(torch_prefix):]
        sd[key] = INVERSE_TRANSFORMS[kind](leaf)
    return sd


def jax_params_from_torch(model, shapes):
    """The flax parameter tree of `shapes` (jax.eval_shape of the flax init,
    without the 'params' wrapper) filled with `model`'s parameters through
    the port's own mapping (convert.flax_to_torch), so that both sides hold
    the same weights without compiling the flax init."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}

    def fill(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, Mapping):
                out[k] = fill(v, path + (k,))
                continue
            key, kind = flax_to_torch(path + (k,))
            out[k] = TRANSFORMS[kind](sd[key]).astype(np.float32)
            assert out[k].shape == v.shape, (key, out[k].shape, v.shape)
        return out

    return fill(shapes, ())


def load(module, sd):
    module.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return module.eval()


def t(x):
    """numpy -> torch (bool/int/float kept)."""
    return torch.from_numpy(np.array(x))


def close(got, want, tol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def write_a2d_tree(root):
    """A2D-Sentences in the reference's layout under `root`: videoset.csv
    and a2d_annotation.txt at their full row counts (the loaders check them;
    rows without masks add no sample), two 12-frame 48 x 64 mp4s, h5 masks
    with one or two instances, a missed video and a '1 (copy)' row. The
    train split has 4 samples (vid0), the test split 2 (vid1)."""
    import cv2
    import h5py

    (root / "Release" / "clips320H").mkdir(parents=True)
    rng = np.random.RandomState(0)
    for vid in ("vid0", "vid1"):
        vw = cv2.VideoWriter(str(root / "Release" / "clips320H" / f"{vid}.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
        assert vw.isOpened(), "mp4v codec unavailable"
        for _ in range(12):
            vw.write(rng.randint(0, 255, (48, 64, 3), np.uint8))
        vw.release()
    rows = ["vid0,0,0,0,0,0,0,0,0", "vid1,0,0,0,0,0,0,0,1", "vid_missed,0,0,0,0,0,0,0,0"]
    rows += [f"pad{i},0,0,0,0,0,0,0,{i % 2}" for i in range(3782 - len(rows))]
    (root / "Release" / "videoset.csv").write_text("\n".join(rows) + "\n")
    ta = root / "text_annotations"
    ta.mkdir()
    (ta / "a2d_missed_videos.txt").write_text("vid_missed\n")
    ann = ["video_id,instance_id,query", "vid0,1,The man  Running left", "vid0,2,a brown dog",
           "vid1,1,a red car", "vid1,1 (copy),a duplicate", "vid_missed,1,never used"]
    ann += [f"elsewhere{i},1,padding row" for i in range(6655 - (len(ann) - 1))]
    (ta / "a2d_annotation.txt").write_text("\n".join(ann) + "\n")
    masks = ta / "a2d_annotation_with_instances"
    for vid, frame, instances in (("vid0", 3, [1, 2]), ("vid0", 6, [2]), ("vid0", 9, [1]),
                                  ("vid1", 1, [1]), ("vid1", 12, [1])):
        (masks / vid).mkdir(parents=True, exist_ok=True)
        re_mask = np.zeros((len(instances), 64, 48), np.uint8)  # h5 stores (W, H)
        for n in range(len(instances)):
            x0, y0 = rng.randint(0, 30), rng.randint(0, 20)
            re_mask[n, x0:x0 + 20, y0:y0 + 15] = 1
        with h5py.File(masks / vid / f"{frame:05d}.h5", "w") as f:
            f["instance"] = np.array(instances)
            f["reMask"] = re_mask if len(instances) > 1 else re_mask[0]
    return root


def write_refexp_json(path, image_ids, hw):
    """A refexp COCO json: one captioned image and one polygon instance per id."""
    h, w = hw
    images, annotations = [], []
    for i, iid in enumerate(image_ids):
        images.append({"id": iid, "file_name": f"img_{iid}.jpg", "height": h, "width": w,
                       "caption": f"the  Red square number {i}"})
        x0, y0, x1, y1 = 4 + i, 5, 20 + i, 25
        annotations.append({"id": 1000 + iid, "image_id": iid, "category_id": 1,
                            "segmentation": [[x0, y0, x1, y0, x1, y1, x0, y1]],
                            "bbox": [x0, y0, x1 - x0, y1 - y0],
                            "area": float((x1 - x0) * (y1 - y0)), "iscrowd": 0})
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"images": images, "annotations": annotations,
                                "categories": [{"id": 1, "name": "object"}]}))


def write_refcoco_tree(root, train_ids=(1, 2, 3, 4, 5)):
    """RefCOCO in the MDETR layout under `root`: 32 x 40 train2014 images,
    the refcoco train json over `train_ids`, and val jsons of refcoco (images
    6, 7) and refcoco+ (image 6) under the two names the resolver tries."""
    from PIL import Image

    img_dir = root / "train2014"
    img_dir.mkdir(parents=True)
    rng = np.random.RandomState(2)
    for iid in range(1, 8):
        arr = rng.randint(0, 255, (32, 40, 3), np.uint8)
        arr[5:25, 4:20] = (200, 30, 30)
        Image.fromarray(arr).save(img_dir / f"img_{iid}.jpg")
    ann = root / "annotations"
    write_refexp_json(ann / "finetune_refcoco_train.json", list(train_ids), (32, 40))
    write_refexp_json(ann / "instances_refcoco_val.json", [6, 7], (32, 40))
    write_refexp_json(ann / "finetune_refcoco+_val.json", [6], (32, 40))
    return root


def perturb_sampling_offsets(tree, rng):
    """At init the sampling offsets' kernel is zero, so every encoder sample
    sits exactly on a pixel centre, a kink of the bilinear sampling where the
    two frameworks' last-bit differences pick different one-sided slopes.
    A small random kernel moves the samples off the kinks."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb_sampling_offsets(v, rng) if k != "sampling_offsets" else {
                kk: (vv + 0.05 * rng.randn(*vv.shape)).astype(np.float32) if kk == "kernel"
                else vv for kk, vv in v.items()}
        else:
            out[k] = v
    return out


class NoFlaxDropout:
    """flax's Dropout as the identity while a JAX function is traced."""

    def __enter__(self):
        import flax.linen

        self.saved = flax.linen.Dropout.__call__
        flax.linen.Dropout.__call__ = lambda self, inputs, deterministic=None, rng=None: inputs

    def __exit__(self, *exc):
        import flax.linen

        flax.linen.Dropout.__call__ = self.saved


def train_step_pair(b, kw, valid_indices=False):
    """One training forward, criterion and backward of the JAX SOC (one
    jitted value_and_grad) and of the port's on the collated batch `b`, with
    the same weights: the port's seeded init (seed 0) with the sampling
    offsets moved off the pixel grid, dropout off on both sides. Both run
    `head(backbone_features(x), ..., training=True)` (JAX's Swin drop path has
    no off switch), with the batch's `valid_indices` when asked (the A2D
    centre-frame step). Returns (port model, JAX results {loss, losses, out,
    grads}, port results {loss, losses, out}); the port's gradients are on
    its parameters."""
    from neurips2023_soc_torch.convert import load_jax_params
    from neurips2023_soc_torch.losses import CriterionConfig, compute_criterion, total_loss
    from neurips2023_soc_torch.models.common import Dropout, init_weights
    from neurips2023_soc_torch.models.soc import SOC
    from neurips2023_soc_torch.training.train_step import TARGET_KEYS
    from neurips2023_soc_tpu.losses import CriterionConfig as JaxCriterionConfig
    from neurips2023_soc_tpu.losses import compute_criterion as jax_criterion
    from neurips2023_soc_tpu.losses import total_loss as jax_total_loss
    from neurips2023_soc_tpu.models.soc import SOC as JaxSOC

    inputs = [b[k] for k in ("pixels", "pad_mask", "text_ids", "text_mask")]
    jm = JaxSOC(dropout=0.0, **kw)
    tm = init_weights(SOC(dropout=0.0, **kw), torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *inputs)
    params = {"params": jax_params_from_torch(tm, shapes["params"])}
    params = perturb_sampling_offsets(params, np.random.RandomState(0))
    load_jax_params(tm, params)
    for m in tm.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    targets = {k: b[k] for k in TARGET_KEYS}
    valid = b["valid_indices"] if valid_indices else None

    def loss_fn(p):
        feats = jm.apply(p, b["pixels"], b["pad_mask"], method=jm.backbone_features)
        out = jm.apply(p, feats, b["pad_mask"], b["text_ids"], b["text_mask"],
                       sample_sizes=b["sample_sizes"], valid_indices=valid, training=True,
                       method=jm.head, rngs={"dropout": jax.random.PRNGKey(1)})
        losses = jax_criterion(out, targets, JaxCriterionConfig())
        return jax_total_loss(losses, JaxCriterionConfig()), (losses, out)

    with NoFlaxDropout():
        (loss, (losses, out)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params)

    t = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items() if hasattr(v, "ndim")}
    feats = tm.backbone_features(t["pixels"], t["pad_mask"])
    tout = tm.head(feats, t["pad_mask"], t["text_ids"], t["text_mask"],
                   sample_sizes=t["sample_sizes"],
                   valid_indices=t["valid_indices"] if valid_indices else None, training=True,
                   rng=torch.Generator())
    tlosses = compute_criterion(tout, {k: t[k] for k in TARGET_KEYS}, CriterionConfig())
    tloss = total_loss(tlosses, CriterionConfig())
    tloss.backward()
    return tm, dict(loss=loss, losses=losses, out=out, grads=grads), \
        dict(loss=tloss, losses=tlosses, out=tout)


def assert_losses_and_gradients_match(tm, jax_res, port):
    """Every loss term and the total, the global gradient norm (over all
    parameters, the frozen text encoder's zeros included) and named
    gradients at 1e-4; a gradient's absolute tolerance is 1e-4 of its
    largest magnitude, as the mask logits' (f32 cancellation through the
    dynamic mask head)."""
    from neurips2023_soc_torch.convert import state_dict_from_jax
    from neurips2023_soc_torch.training.optim import global_norm

    jlosses, jgrads = jax_res["losses"], jax_res["grads"]
    losses, loss = port["losses"], port["loss"]
    assert sorted(losses) == sorted(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(losses[k].item(), float(jlosses[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(loss.item(), float(jax_res["loss"]), rtol=1e-4, atol=1e-4)
    want = state_dict_from_jax(jgrads)
    np.testing.assert_allclose(global_norm(p.grad for p in tm.parameters()).item(),
                               np.sqrt(sum(np.square(w, dtype=np.float64).sum()
                                           for w in want.values())), rtol=1e-4)
    got = dict(tm.named_parameters())
    for name in ("class_embed.1.weight", "bbox_embed.0.layers.2.bias", "controller.layers.0.weight",
                 "transformer.level_embed",
                 "transformer.encoder.layers.0.self_attn.sampling_offsets.weight",
                 "transformer.decoder.layers.1.cross_attn.value_proj.weight",
                 "voc.query_embed.weight", "txt_proj.fc.weight", "vlf.multihead_attn.in_proj_weight",
                 "backbone.0.body.layers.3.blocks.1.mlp.fc2.weight",
                 "backbone.0.body.patch_embed.proj.weight"):
        w = want[name]
        np.testing.assert_allclose(got[name].grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(np.abs(w).max())), err_msg=name)
    # the frozen encoder's gradient: zero in JAX (stop_gradient), none here
    assert all(p.grad is None for n, p in got.items() if n.startswith("text_encoder."))
    assert max(float(np.abs(v).max()) for k, v in want.items()
               if k.startswith("text_encoder.")) == 0.0
