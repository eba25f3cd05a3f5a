"""K3, Swin window attention: the port's plain version of the TPU kernel's
semantics (`window_attention_ref`) against the JAX Pallas kernel in
interpret mode, on the JAX suite's inputs (tests/test_window_attention.py):
float32 at rtol = atol = 2e-5, bf16 at 2e-2 absolute. Then the wrapper's
routing and refusals, and the `pallas` switch of the backbone."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurips2023_soc_torch.models.common import init_weights
from neurips2023_soc_torch.models.video_swin import build_video_swin
from neurips2023_soc_torch.ops import _build
from neurips2023_soc_torch.ops.window_attention import (mask_from_ids, window_attention,
                                                        window_attention_ref,
                                                        window_attention_torch)
from neurips2023_soc_tpu.ops.window_attention import window_attention_pallas
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)

B_, H, N, Dh, nW = 6, 2, 56, 32, 3  # B_ = 6 is not a multiple of the kernel's Wb = 4


def _inputs(seed=0, with_mask=True):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B_, H, N, Dh).astype(np.float32) for _ in range(3))
    bias = rng.randn(H, N, N).astype(np.float32) * 0.1
    ids = rng.randint(0, 9, size=(nW, N)).astype(np.int32) if with_mask else None
    return q, k, v, bias, ids


def _port(q, k, v, bias, ids, dtype=torch.float32):
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    tids = None if ids is None else torch.from_numpy(ids)
    return window_attention_ref(tq, tk, tv, torch.from_numpy(bias), tids)


@pytest.mark.parametrize("with_mask", [False, True])
def test_ref_matches_pallas_interpret_f32(with_mask):
    q, k, v, bias, ids = _inputs(with_mask=with_mask)
    want = np.asarray(window_attention_pallas(
        q, k, v, bias, None if ids is None else jnp.asarray(ids), interpret=True))
    got = _port(q, k, v, bias, ids)
    assert got.shape == want.shape == (B_, H, N, Dh)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_ref_matches_pallas_interpret_bf16():
    """Both round p to bf16 before p.v and the output once; the sums run in
    another order, so the tolerance is 2e-2 absolute (outputs are O(1))."""
    q, k, v, bias, ids = _inputs(seed=1)
    cast = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    want = np.asarray(window_attention_pallas(cast(q), cast(k), cast(v), bias,
                                              jnp.asarray(ids), interpret=True))
    got = _port(q, k, v, bias, ids, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=0,
                               atol=2e-2)


def _tiled_bf16_mirror(q, k, v, bias, ids):
    """The bf16 kernel's arithmetic order in plain torch: scores in the log2
    domain (f32 q.k times Dh^-1/2 log2(e), plus log2(e) times the f32 bias
    and the -100 mask); keys in steps of 64, then 16 up to N; the first
    ceil(full / 2) 64-key steps in one half and the rest in the other, each
    half with its own running max m and sum l per row; p = exp2(s - m)
    unnormalised, rounded to bf16 for P.V, summed in f32; the halves merged,
    one division by the row sum, one rounding of the output."""
    B_, H_, N_, Dh_ = q.shape
    log2e = 1.4426950408889634
    s = (q.float() @ k.float().transpose(-2, -1)) * (Dh_ ** -0.5 * log2e)
    s = s + bias.float()[None] * log2e
    if ids is not None:
        nW_ = ids.shape[0]
        s = (s.view(B_ // nW_, nW_, H_, N_, N_) + log2e * mask_from_ids(ids)[None, :, None]
             ).view(B_, H_, N_, N_)
    full = N_ // 64
    split = (full + 1) // 2
    halves = [[(j, 64) for j in range(0, 64 * split, 64)],
              [(j, 64) for j in range(64 * split, 64 * full, 64)]
              + [(j, 16) for j in range(64 * full, N_, 16)]]
    parts = []
    for steps in halves:
        m = torch.full((B_, H_, N_, 1), -torch.inf)
        l = torch.zeros(B_, H_, N_, 1)
        o = torch.zeros(B_, H_, N_, Dh_)
        for j0, width in steps:
            blk = s[..., j0:j0 + width]
            m_new = torch.maximum(m, blk.amax(-1, keepdim=True))
            c = torch.exp2(m - m_new)
            p = torch.exp2(blk - m_new)
            l = l * c + p.sum(-1, keepdim=True)
            o = o * c + p.to(torch.bfloat16).float() @ v[..., j0:j0 + width, :].float()
            m = m_new
        parts.append((m, l, o))
    (m0, l0, o0), (m1, l1, o1) = parts
    m = torch.maximum(m0, m1)
    c0, c1 = torch.exp2(m0 - m), torch.exp2(m1 - m)
    return ((o0 * c0 + o1 * c1) / (l0 * c0 + l1 * c1)).to(torch.bfloat16)


@pytest.mark.parametrize("with_mask", [False, True])
def test_tiled_bf16_order_matches_pallas_interpret(with_mask):
    """Rounding the unnormalised p (the card's bf16 kernel) instead of the
    normalised p (the TPU kernel) keeps the output within the card's
    tolerance of the Pallas kernel: two bf16 ulps of the largest output
    (2 * 2**-7 * max|out|). N = 56 ends in a ragged 16-key step."""
    q, k, v, bias, ids = _inputs(seed=4, with_mask=with_mask)
    cast = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    want = np.asarray(window_attention_pallas(
        cast(q), cast(k), cast(v), bias, None if ids is None else jnp.asarray(ids),
        interpret=True)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = _tiled_bf16_mirror(tq, tk, tv, torch.from_numpy(bias),
                             None if ids is None else torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16 and got.shape == (B_, H, N, Dh)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 * 2.0 ** -7 * np.abs(want).max())


def test_cpu_tensors_take_the_plain_version():
    q, k, v, bias, ids = (None if a is None else torch.from_numpy(a) for a in _inputs(2))
    window_attention.plain_calls = window_attention.launches = 0
    out = window_attention(q, k, v, bias, ids)
    assert window_attention.plain_calls == 1 and window_attention.launches == 0
    torch.testing.assert_close(out, window_attention_ref(q, k, v, bias, ids), rtol=0, atol=0)


def test_wrapper_refuses_what_the_kernel_cannot_run():
    """A tensor off the CPU goes to the kernel or raises, never to the plain
    version (here a meta tensor, which no kernel takes); and the kernel has no
    backward, so a tensor that requires a gradient is refused."""
    meta = torch.empty(B_, H, N, Dh, device="meta")
    bias = torch.empty(H, N, N, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        window_attention(meta, meta, meta, bias)
    with pytest.raises(RuntimeError, match="no backward"):
        window_attention(meta.requires_grad_(), meta, meta, bias)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all(["window_attention_fwd"])


def test_pallas_backbone_passes_region_ids_not_masks(monkeypatch):
    """With attn_impl='pallas' each of video-swin-t's 12 blocks calls the
    wrapper, the shifted ones (stages 1 and 2 here; stages 3 and 4 clamp the
    window to the 4 x 6 and 2 x 3 grids and drop the shift) hand it the
    (nW, N) ids, and no (nW, N, N) mask is built; the 'xla' default keeps
    window_attention_torch. Both agree in f32 (the JAX parity of each is in
    tests/test_torch_backbones.py)."""
    import neurips2023_soc_torch.models.video_swin as vs

    xla = init_weights(build_video_swin("video-swin-t"), torch.Generator().manual_seed(0))
    pallas = build_video_swin("video-swin-t", attn_impl="pallas")
    pallas.load_state_dict(xla.state_dict())
    seen = []
    monkeypatch.setattr(vs, "window_attention",
                        lambda q, k, v, bias, ids: seen.append(ids) or
                        window_attention(q, k, v, bias, ids))
    built = []
    monkeypatch.setattr(vs, "_attn_mask", lambda *a, **kw: built.append(a) or
                        vs.mask_from_ids(vs._region_ids(*a[:5], torch.device("cpu"))))
    x = torch.from_numpy(np.random.RandomState(3).randn(1, 2, 64, 96, 3).astype(np.float32))
    window_attention_torch.calls = 0
    with torch.no_grad():
        got = pallas(x)
        assert window_attention_torch.calls == 0 and not built
        want = xla(x)
    assert window_attention_torch.calls == len(seen) == 12
    assert [i for i, s in enumerate(seen) if s is not None] == [1, 3]
    assert [tuple(s.shape) for s in seen if s is not None] == [(12, 98), (4, 98)]
    assert all(s.dtype == torch.int32 for s in seen if s is not None)
    assert len(built) == 2
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_unknown_attn_impl_raises():
    with pytest.raises(ValueError, match="attn_impl"):
        build_video_swin("video-swin-t", attn_impl="triton")
