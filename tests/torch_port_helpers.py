"""Helpers for the parity tests of the PyTorch port against the JAX package:
initialize a flax module from numpy inputs, carry its parameters into the
port's twin, and compare outputs as numpy arrays."""
import re
from collections.abc import Mapping

import jax
import numpy as np
import torch

from neurips2023_soc_torch.convert import INVERSE_TRANSFORMS, flax_to_torch

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
