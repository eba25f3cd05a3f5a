"""The port's plain MSDA backward (ops.ms_deform_attn_torch_bwd, the plain
version of the CUDA kernel csrc/ms_deform_attn_bwd.cu) against jax.vjp of the
JAX package's XLA path and against its Pallas backward kernel in interpret
mode, on the CPU in float32 at rtol = atol = 1e-4 (the JAX suite's backward
tolerance, tests/test_pallas_msda.py), and the gradient routing of the
wrapper on CPU tensors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurips2023_soc_tpu.ops.ms_deform_attn import ms_deform_attn_xla
from neurips2023_soc_tpu.ops.pallas_msda import ms_deform_attn_pallas_bwd
from neurips2023_soc_torch.ops.ms_deform_attn import (ms_deform_attn, ms_deform_attn_torch,
                                                      ms_deform_attn_torch_bwd)
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
PALLAS_SHAPES = ((9, 17), (5, 9), (3, 5))


def _inputs(shapes, B, M, D, Lq, P, seed, uniform):
    """The inputs of tests/test_pallas_msda.py: locations around each
    token's centre (Lq == S) or random points, or uniform in [-0.2, 1.2];
    attention weights normalized over (L, P); a random cotangent."""
    rng = np.random.RandomState(seed)
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    v = rng.randn(B, S, M, D).astype(np.float32)
    if uniform:
        loc = (rng.rand(B, Lq, M, L, P, 2) * 1.4 - 0.2).astype(np.float32)
    else:
        if Lq == S:
            pts = []
            for h, w in shapes:
                yy, xx = np.meshgrid(np.arange(h) + .5, np.arange(w) + .5, indexing="ij")
                pts.append(np.stack([xx.ravel() / w, yy.ravel() / h], -1))
            rp = np.concatenate(pts, 0)
        else:
            rp = rng.rand(Lq, 2)
        loc = np.clip(rp[None, :, None, None, None, :]
                      + rng.randn(B, Lq, M, L, P, 2) * 0.05, 0, 1).astype(np.float32)
    a = rng.rand(B, Lq, M, L, P).astype(np.float32)
    a = a / a.sum((-1, -2), keepdims=True)
    g = rng.randn(B, Lq, M * D).astype(np.float32)
    return v, loc, a, g


# (shapes, B, M, D, Lq, P, uniform): the bwd cases of tests/test_pallas_msda.py,
# a two-level cut of them (small enough for the Pallas interpreter), size-1
# levels, and locations far outside [0, 1]
CASES = {
    "two_levels": (PALLAS_SHAPES[1:], 1, 2, 8, 7, 2, False),
    "pallas_encoder": (PALLAS_SHAPES, 2, 2, 8, None, 2, False),
    "pallas_uniform": (PALLAS_SHAPES, 2, 2, 8, None, 2, True),
    "pallas_decoder": (PALLAS_SHAPES, 2, 2, 8, 7, 2, False),
    "size1_pyramid": (((16, 24), (8, 12), (4, 6), (1, 2), (1, 1)), 2, 2, 4, 9, 2, True),
    "size1_col": (((4, 1),), 2, 2, 4, 7, 3, True),
    "far_out_of_range": (((6, 5), (3, 3), (1, 1)), 1, 2, 4, 11, 3, True),
}


def _case(name, seed=11):
    shapes, B, M, D, Lq, P, uniform = CASES[name]
    Lq = sum(h * w for h, w in shapes) if Lq is None else Lq
    v, loc, a, g = _inputs(shapes, B, M, D, Lq, P, seed, uniform)
    if name == "far_out_of_range":
        loc = (loc * 4.0 - 1.5).astype(np.float32)
    return shapes, v, loc, a, g


def _port_bwd(shapes, v, loc, a, g):
    return [x.numpy() for x in ms_deform_attn_torch_bwd(
        torch.from_numpy(v), shapes, torch.from_numpy(loc), torch.from_numpy(a),
        torch.from_numpy(g))]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_bwd_vs_jax_vjp(case):
    shapes, v, loc, a, g = _case(case)

    @jax.jit
    def vjp(v, loc, a, g):
        return jax.vjp(lambda v, l, a: ms_deform_attn_xla(v, shapes, l, a), v, loc, a)[1](g)

    want = vjp(v, loc, a, g)
    for name, got, w in zip(("d_value", "d_loc", "d_attn"), _port_bwd(shapes, v, loc, a, g),
                            want):
        np.testing.assert_allclose(got, np.asarray(w), err_msg=name, **TOL)


def test_plain_bwd_vs_pallas_bwd_interpret():
    shapes, v, loc, a, g = _case("two_levels")
    want = ms_deform_attn_pallas_bwd(v, shapes, loc, a, jnp.asarray(g), interpret=True)
    for name, got, w in zip(("d_value", "d_loc", "d_attn"), _port_bwd(shapes, v, loc, a, g),
                            want):
        np.testing.assert_allclose(got, np.asarray(w), err_msg=name, **TOL)


def test_cpu_gradients_take_the_plain_backward():
    """Autograd through the wrapper on CPU tensors differentiates the plain
    version (counted once) and equals the plain backward exactly; no kernel
    is launched."""
    shapes, v, loc, a, g = _case("size1_pyramid", seed=3)
    ins = [torch.from_numpy(x).requires_grad_() for x in (v, loc, a)]
    counts = (ms_deform_attn.launches, ms_deform_attn.bwd_launches,
              ms_deform_attn.plain_bwd_calls)
    out = ms_deform_attn(ins[0], shapes, ins[1], ins[2])
    out.backward(torch.from_numpy(g))
    assert (ms_deform_attn.launches, ms_deform_attn.bwd_launches,
            ms_deform_attn.plain_bwd_calls) == (counts[0], counts[1], counts[2] + 1)
    want = ms_deform_attn_torch_bwd(torch.from_numpy(v), shapes,
                                    torch.from_numpy(loc), torch.from_numpy(a),
                                    torch.from_numpy(g))
    for x, w in zip(ins, want):
        torch.testing.assert_close(x.grad, w, rtol=0, atol=0)


def test_plain_bwd_dtypes_follow_the_inputs():
    """bf16 value/weights: each gradient comes back in its input's dtype,
    d_value from one rounding of its float32 sum."""
    shapes, v, loc, a, g = _case("pallas_decoder", seed=4)
    vb, ab, gb = (torch.from_numpy(x).bfloat16() for x in (v, a, g))
    lt = torch.from_numpy(loc)
    dv, dl, da = ms_deform_attn_torch_bwd(vb, shapes, lt, ab, gb)
    assert (dv.dtype, dl.dtype, da.dtype) == (torch.bfloat16, torch.float32, torch.bfloat16)
    want = ms_deform_attn_torch_bwd(vb.float(), shapes, lt, ab.float(), gb.float())
    torch.testing.assert_close(dv, want[0].bfloat16(), rtol=0, atol=0)


def test_plain_bwd_matches_finite_differences_of_the_locations():
    """d_loc is W * dL/dx for x = loc_x * W - 0.5: central differences of
    <out, g> inside one bilinear cell, where the sample is linear in x (the
    plain version computes in float32, so the step is 1e-3 and the
    tolerance 1e-3)."""
    shapes = ((5, 7), (3, 4))
    rng = np.random.RandomState(5)
    S = sum(h * w for h, w in shapes)
    v = torch.from_numpy(rng.randn(1, S, 1, 3).astype(np.float32))
    a = torch.from_numpy(rng.rand(1, 2, 1, 2, 2).astype(np.float32))
    g = torch.from_numpy(rng.randn(1, 2, 3).astype(np.float32))
    # pixel coordinates a quarter cell from any edge on every level
    cells = rng.randint(0, 2, (1, 2, 1, 2, 2, 2)) + 0.25 + 0.5 * rng.rand(1, 2, 1, 2, 2, 2)
    wh = np.array([[w, h] for h, w in shapes], np.float64)[None, None, None, :, None, :]
    loc = torch.from_numpy(((cells + 0.5) / wh).astype(np.float32))
    _, d_loc, _ = ms_deform_attn_torch_bwd(v, shapes, loc, a, g)
    eps = 1e-3
    for idx in [(0, 0, 0, 0, 0, 0), (0, 1, 0, 1, 1, 1), (0, 0, 0, 1, 0, 1)]:
        lp, lm = loc.clone(), loc.clone()
        lp[idx] += eps
        lm[idx] -= eps
        fd = ((ms_deform_attn_torch(v, shapes, lp, a) * g).sum()
              - (ms_deform_attn_torch(v, shapes, lm, a) * g).sum()) / (2 * eps)
        np.testing.assert_allclose(d_loc[idx].item(), fd.item(), rtol=1e-3, atol=1e-3)


def test_kernel_backward_refuses_cpu_tensors():
    """The backward kernel takes CUDA tensors only and says so; it does not
    fall back to the plain version."""
    from neurips2023_soc_torch.ops.ms_deform_attn import _launch_bwd

    shapes, v, loc, a, g = _case("size1_col")
    with pytest.raises(ValueError, match="CUDA"):
        _launch_bwd(torch.from_numpy(v), shapes, torch.from_numpy(loc),
                    torch.from_numpy(a), torch.from_numpy(g))



@pytest.mark.parametrize("D, P, route", [
    (32, 4, "vec"),  # the path's heads
    (8, 4, "vec"),  # d_model 64 over 8 heads (configs/tiny_synthetic.yaml)
    (128, 4, "vec"), (16, 3, "vec"),
    (24, 4, "scalar"),  # D / 8 = 3 threads would straddle a warp
    (4, 4, "scalar"), (256, 4, "scalar"),  # 32 threads per group: over 1024 per CTA
    (8, 32, "scalar"),  # the hit table of 32 points per level exceeds shared memory
])
def test_bwd_route_by_shape(D, P, route):
    from neurips2023_soc_torch.ops.ms_deform_attn import bwd_route

    assert bwd_route(D, P) == route
