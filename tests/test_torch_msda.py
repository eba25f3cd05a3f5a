"""The port's plain MSDA (neurips2023_soc_torch.ops.ms_deform_attn_torch)
against the JAX package's XLA path and its Pallas kernel in interpret mode,
on the CPU in float32 (atol = rtol = 1e-5), and the dispatch rule of the
kernel wrapper: a CPU tensor goes to the plain version, never the kernel."""
import numpy as np
import pytest
import torch

from neurips2023_soc_tpu.ops.ms_deform_attn import ms_deform_attn_xla
from neurips2023_soc_tpu.ops.pallas_msda import ms_deform_attn_pallas
from neurips2023_soc_torch.ops import level_start_index, ms_deform_attn, ms_deform_attn_torch
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(shapes, B, M, D, Lq, P, seed, uniform=True):
    """Uniform locations in [-0.2, 1.2] (out-of-range corners included), or
    locations around each token's centre (Lq == S) / random points."""
    rng = np.random.RandomState(seed)
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    value = rng.randn(B, S, M, D).astype(np.float32)
    if uniform:
        loc = rng.uniform(-0.2, 1.2, size=(B, Lq, M, L, P, 2)).astype(np.float32)
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
    attn = rng.rand(B, Lq, M, L, P).astype(np.float32)
    attn /= attn.reshape(B, Lq, M, -1).sum(-1).reshape(B, Lq, M, 1, 1)
    return value, loc, attn


def _port(shapes, value, loc, attn):
    return ms_deform_attn_torch(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                                torch.from_numpy(attn)).numpy()


# (shapes, B, M, D, Lq, P, uniform): the shapes of tests/test_ms_deform_attn.py
# and tests/test_pallas_msda.py, size-1 levels, Lq != S
XLA_CASES = {
    "ms_deform_attn_suite": (((12, 16), (6, 8), (3, 4)), 2, 4, 8, 17, 4, True),
    "pallas_suite_encoder": (((9, 17), (5, 9), (3, 5)), 2, 2, 8, 223, 3, False),
    "pallas_suite_uniform": (((9, 17), (5, 9), (3, 5)), 2, 2, 8, 223, 3, True),
    "pallas_suite_decoder": (((9, 17), (5, 9), (3, 5)), 2, 2, 8, 7, 3, False),
    "size1_row": (((1, 2),), 2, 2, 4, 7, 2, True),
    "size1_col": (((4, 1),), 2, 2, 4, 7, 2, True),
    "size1_point": (((1, 1),), 2, 2, 4, 7, 2, True),
    "size1_pyramid": (((16, 24), (8, 12), (4, 6), (1, 2)), 2, 2, 4, 7, 2, True),
    "far_out_of_range": (((6, 5), (3, 3), (1, 1)), 1, 2, 4, 11, 3, True),
}


@pytest.mark.parametrize("case", sorted(XLA_CASES))
def test_plain_vs_jax_xla(case):
    shapes, B, M, D, Lq, P, uniform = XLA_CASES[case]
    value, loc, attn = _inputs(shapes, B, M, D, Lq, P, seed=len(case), uniform=uniform)
    if case == "far_out_of_range":
        loc = loc * 4.0 - 1.5  # most samples land wholly or partly outside
    want = np.asarray(ms_deform_attn_xla(value, shapes, loc, attn))
    np.testing.assert_allclose(_port(shapes, value, loc, attn), want, **TOL)


@pytest.mark.parametrize("case", ["pallas_suite_encoder", "pallas_suite_uniform",
                                  "pallas_suite_decoder"])
def test_plain_vs_jax_pallas_interpret(case):
    shapes, B, M, D, Lq, P, uniform = XLA_CASES[case]
    value, loc, attn = _inputs(shapes, B, M, D, Lq, P, seed=len(case), uniform=uniform)
    want = np.asarray(ms_deform_attn_pallas(value, shapes, loc, attn, interpret=True))
    np.testing.assert_allclose(_port(shapes, value, loc, attn), want, **TOL)


def test_level_start_index():
    assert level_start_index(((12, 16), (6, 8), (3, 4))) == (0, 192, 240)


def test_cpu_call_takes_the_plain_version():
    shapes = ((12, 16), (6, 8), (3, 4))
    value, loc, attn = (torch.from_numpy(a) for a in
                        _inputs(shapes, 2, 4, 8, 17, 4, seed=3))
    launches, plain = ms_deform_attn.launches, ms_deform_attn.plain_calls
    out = ms_deform_attn(value, shapes, loc, attn)
    assert ms_deform_attn.launches == launches
    assert ms_deform_attn.plain_calls == plain + 1
    torch.testing.assert_close(out, ms_deform_attn_torch(value, shapes, loc, attn),
                               rtol=0, atol=0)
    assert out.shape == (2, 17, 32) and out.dtype == torch.float32


def test_plain_bf16_accumulates_in_f32():
    """bf16 inputs: f32 sums, one rounding of the output to bf16."""
    shapes = ((12, 16), (6, 8), (3, 4))
    value, loc, attn = (torch.from_numpy(a) for a in
                        _inputs(shapes, 2, 4, 8, 17, 4, seed=4))
    vb, ab = value.bfloat16(), attn.bfloat16()
    out = ms_deform_attn_torch(vb, shapes, loc, ab)
    assert out.dtype == torch.bfloat16
    want = ms_deform_attn_torch(vb.float(), shapes, loc, ab.float()).bfloat16()
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_kernel_launch_refuses_cpu_tensors():
    """The kernel path takes CUDA tensors only and says so; it does not fall
    back to the plain version."""
    from neurips2023_soc_torch.ops.ms_deform_attn import _launch

    shapes = ((3, 4),)
    value, loc, attn = (torch.from_numpy(a) for a in
                        _inputs(shapes, 1, 2, 4, 5, 2, seed=5))
    with pytest.raises(ValueError, match="CUDA"):
        _launch(value, shapes, loc, attn)


@pytest.mark.parametrize("D, P, route", [
    (32, 4, "vec"),  # the path's heads: 4 threads of 8 channels per (b, q, m)
    (8, 4, "vec"),  # d_model 64 over 8 heads (configs/tiny_synthetic.yaml)
    (256, 4, "vec"), (16, 3, "vec"),
    (24, 4, "scalar"),  # D / 8 = 3 threads would straddle a warp
    (4, 4, "scalar"), (512, 4, "scalar"),
    (8, 8, "scalar"),  # 256 groups x 8 samples x 32 bytes of staging > 48 KB
])
def test_fwd_route_by_shape(D, P, route):
    from neurips2023_soc_torch.ops.ms_deform_attn import fwd_route

    assert fwd_route(D, P) == route


def test_kernel_library_hashes_its_headers(tmp_path, monkeypatch):
    """An edited header that a kernel includes changes the library's name, so
    the kernel is rebuilt; a header it does not include does not."""
    from neurips2023_soc_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda_runtime.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "c.cuh").write_text("// c\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert sorted(p.name for p in _build.sources("k")) == ["a.cuh", "b.cuh", "k.cu"]
    before = _build.library_path("k")
    (tmp_path / "c.cuh").write_text("// c, edited\n")
    assert _build.library_path("k") == before
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert _build.library_path("k") != before
