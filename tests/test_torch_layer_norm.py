"""The LayerNorm kernel (csrc/layer_norm_fwd.cu) and its wrapper
(ops/layer_norm.py). On the CPU: `layer_norm_ref` is the module's arithmetic
bit for bit, the route (kernel only for a CUDA input, bfloat16 out and no
gradient; the plain version counted otherwise), the build list and the
engine's counters. On the card (marker `card`): the kernel against the plain
version at the benchmark cells' norm shapes, against the float32 result
before its rounding, and one bfloat16 inference pass whose every bfloat16 norm
launches the kernel. Run the card tests with

    python -m pytest tests/test_torch_layer_norm.py -m card --confcutdir=tests
"""
import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neurips2023_soc_torch import inference
from neurips2023_soc_torch.models.common import LayerNorm, init_weights
from neurips2023_soc_torch.ops import _build
from neurips2023_soc_torch.ops.layer_norm import layer_norm, layer_norm_ref

try:  # the CPU suite's thread share; its helpers import JAX, which the card machine lacks
    from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)
except ImportError:
    pass

ln_mod = importlib.import_module("neurips2023_soc_torch.ops.layer_norm")
BF16, F32 = torch.bfloat16, torch.float32


def _params(C, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    w = 1.0 + 0.1 * torch.randn(C, generator=g)
    b = 0.02 * torch.randn(C, generator=g)
    return w.to(device), b.to(device)


def _input(rows, C, dtype, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = 0.3 + 2.0 * torch.randn(rows, C, generator=g)
    return x.to(device, dtype)


@pytest.mark.parametrize("eps", [1e-6, 1e-12])
@pytest.mark.parametrize("C", [128, 192, 256, 768, 3072])
@pytest.mark.parametrize("x_dtype,dtype", [(BF16, BF16), (F32, F32), (F32, BF16)])
def test_layer_norm_ref_is_the_module_arithmetic(C, eps, x_dtype, dtype):
    """layer_norm_ref and LayerNorm.forward equal F.layer_norm on the upcast
    input, rounded once to the module's dtype, bit for bit."""
    x = _input(5, C, x_dtype, seed=C)
    m = LayerNorm(C, eps=eps, dtype=dtype)
    w, b = _params(C, seed=C + 1)
    with torch.no_grad():
        m.weight.copy_(w)
        m.bias.copy_(b)
        want = F.layer_norm(x.float(), (C,), m.weight, m.bias, eps).to(dtype)
        got_ref = layer_norm_ref(x, m.weight, m.bias, eps, dtype)
        got_mod = m(x)
    assert got_ref.dtype == got_mod.dtype == dtype
    assert torch.equal(got_ref, want) and torch.equal(got_mod, want)


class _CudaLike(torch.Tensor):
    """A CPU tensor that reads as a CUDA one, so the route's other conditions
    can be tested without a card."""

    @property
    def is_cuda(self):
        return True


def _route_cases():
    def cuda_like(t):
        return torch.Tensor._make_subclass(_CudaLike, t, t.requires_grad)

    x = _input(3, 16, BF16, seed=0)
    w, b = _params(16, seed=1)
    wg, bg = (torch.nn.Parameter(t.clone()) for t in (w, b))
    return {
        "cpu tensor": (x, w, b, BF16, torch.no_grad, False),
        "float32 module": (cuda_like(x), w, b, F32, torch.no_grad, False),
        "gradient needed": (cuda_like(x), wg, bg, BF16, torch.enable_grad, False),
        "grad mode, nothing requires grad": (cuda_like(x), w, b, BF16, torch.enable_grad,
                                             True),
        "parameters under no_grad": (cuda_like(x), wg, bg, BF16, torch.no_grad, True),
        "inference mode": (cuda_like(x), wg, bg, BF16, torch.inference_mode, True),
    }


@pytest.mark.parametrize("case", list(_route_cases()))
def test_route_by_device_dtype_and_gradient(case, monkeypatch):
    """The kernel is chosen only for a CUDA input, bfloat16 out and no
    gradient; every other call goes to layer_norm_ref and is counted."""
    x, w, b, dtype, mode, kernel = _route_cases()[case]
    launched = []
    monkeypatch.setattr(ln_mod, "_launch",
                        lambda *args: launched.append(args) or torch.zeros(()))
    monkeypatch.setattr(layer_norm, "plain_calls", 0)
    with mode():
        out = layer_norm(x, w, b, 1e-6, dtype)
    assert len(launched) == int(kernel)
    assert layer_norm.plain_calls == int(not kernel)
    if not kernel:
        assert out.dtype == dtype and out.shape == x.shape


def test_module_on_the_cpu_counts_plain_calls(monkeypatch):
    monkeypatch.setattr(layer_norm, "plain_calls", 0)
    monkeypatch.setattr(layer_norm, "launches", 0)
    m = init_weights(LayerNorm(32, dtype=BF16), torch.Generator().manual_seed(0))
    with torch.no_grad():
        for _ in range(3):
            m(_input(4, 32, BF16, seed=2))
    assert (layer_norm.plain_calls, layer_norm.launches) == (3, 0)


def test_compare_to_ref_reads_ulps_and_nans():
    """compare_to_ref: equal results read 0, one bf16 ulp reads at most 1, two
    ulps beyond 1, and a NaN where the reference has a number reads beyond
    the bound."""
    want = torch.tensor([[1.0, -0.5, 3.0, 0.25]], dtype=BF16)
    assert ln_mod.compare_to_ref(want, want)[:2] == (0.0, 0.0)
    one_ulp = want.float() + ln_mod.bf16_ulp(want) * torch.tensor([[0, 0, 1, 0]])
    share, worst, i = ln_mod.compare_to_ref(one_ulp.to(BF16), want)
    assert (share, i) == (0.25, 2) and 0.99 < worst <= 1.0
    two_ulps = want.float() + 2 * ln_mod.bf16_ulp(want) * torch.tensor([[0, 1, 0, 0]])
    share, worst, i = ln_mod.compare_to_ref(two_ulps.to(BF16), want)
    assert i == 1 and 1.9 < worst <= 2.0
    nan = want.clone()
    nan[0, 3] = float("nan")
    assert ln_mod.compare_to_ref(nan, want)[1:] == (float("inf"), 3)


def test_kernel_is_built_and_counted():
    assert "layer_norm_fwd" in _build.KERNELS
    src = _build._source("layer_norm_fwd")
    assert src.suffix == ".cu" and src.exists()
    assert 'extern "C" int ln_fwd(' in src.read_text()
    counters = inference._kernel_counters()
    assert (layer_norm, "launches") in counters and (layer_norm, "plain_calls") in counters


# ---------------------------------------------------------------- on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (C, rows) of the norms of the two benchmark cells at 360 x 640, at the largest time bucket
# (64 padded frames; Video-Swin-B's patch takes 2 frames, so 32 on its grid) and at the
# smallest (8): the Swin blocks and stage norms at 90 x 160, 45 x 80, 23 x 40 and 12 x 20
# tokens a frame, the PatchMerging norms at 4 C, the head at 4820 tokens a frame for 256
# frame-expressions (HEAD_ROWS) and RoBERTa's 768 at 8 expressions of 32 tokens.
def _cell_shapes():
    grid = (90 * 160, 45 * 80, 23 * 40, 12 * 20)
    shapes = set()
    for frames in (64, 8):
        for dims, t in (((192, 384, 768, 1536), frames), ((128, 256, 512, 1024), frames // 2)):
            for s, C in enumerate(dims):
                shapes.add((C, grid[s] * t))
                if s < 3:
                    shapes.add((4 * C, grid[s + 1] * t))
    shapes |= {(256, 4820 * 256), (256, 20 * 256), (768, 8 * 32), (512, 20 * 256)}
    return sorted(shapes)


def _compare(x, w, b, eps):
    """The kernel against layer_norm_ref on the card (ln_mod.compare_to_ref):
    (share of elements that differ, largest difference over its bound, that
    element's values)."""
    got = ln_mod._launch(x, w, b, eps)
    want = layer_norm_ref(x, w, b, eps, BF16)
    assert got.shape == x.shape and got.is_contiguous()
    share, worst, i = ln_mod.compare_to_ref(got, want)
    at = dict(got=got.flatten()[i].item(), want=want.flatten()[i].item())
    return share, worst, at


def _failed(share, worst):
    return share > ln_mod.MAX_DIFFER_SHARE or worst > 1.0


@pytest.mark.card
def test_kernel_against_the_plain_version_at_the_cells_shapes():
    """At most one bf16 ulp apart (plus float32 rounding of the row's
    statistics, see compare_to_ref) and at most 0.1 % of the elements
    differing, at every (C, rows) of the two cells, a ragged row count, a
    strided input, float32 input and both epsilons."""
    dev = _card()
    cases = [(f"C={C} rows={rows}", C, rows, BF16, 1e-6) for C, rows in _cell_shapes()]
    cases += [("ragged", 192, 1001, BF16, 1e-6), ("eps 1e-12", 768, 4099, BF16, 1e-12),
              ("f32 in", 768, 2053, F32, 1e-6), ("f32 in, C=256", 256, 4097, F32, 1e-6),
              ("Swin-T", 96, 7001, BF16, 1e-6), ("C=40 scalar", 40, 333, BF16, 1e-6),
              ("C=4104 scalar", 4104, 65, BF16, 1e-6), ("one row", 3072, 1, BF16, 1e-6)]
    failures = []
    for i, (tag, C, rows, dtype, eps) in enumerate(cases):
        x = _input(rows, C, dtype, seed=i, device=dev)
        w, b = _params(C, seed=100 + i, device=dev)
        share, worst, at = _compare(x, w, b, eps)
        if _failed(share, worst):
            failures.append(f"{tag}: {share:.2e} of the elements differ, {worst:.3f} of the "
                            f"bound at {at}")
        del x
    # a strided input (the patch embedding's permuted convolution output) and an
    # unaligned view (the scalar route)
    w, b = _params(192, seed=7, device=dev)
    xs = _input(4 * 2 * 45 * 80, 192, BF16, seed=8, device=dev).view(4, 2, 45, 80, 192)
    xs = xs.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1)
    assert not xs.is_contiguous()
    share, worst, at = _compare(xs, w, b, 1e-6)
    if _failed(share, worst):
        failures.append(f"strided: {share:.2e} differ, {worst:.3f} of the bound at {at}")
    xu = _input(1, 257 * 192 + 1, BF16, seed=9, device=dev)[0, 1:].view(257, 192)
    share, worst, at = _compare(xu, w, b, 1e-6)
    if _failed(share, worst):
        failures.append(f"unaligned: {share:.2e} differ, {worst:.3f} of the bound at {at}")
    torch.cuda.synchronize()
    assert not failures, "\n".join(failures)


@pytest.mark.card
@pytest.mark.parametrize("eps", [1e-6, 1e-12])
def test_kernel_on_near_constant_rows(eps):
    """Rows whose variance is near or below eps, where eps sets the result,
    at every width of the cells: bf16 rows near 0 with a variance of about
    1e-7 and float32 rows near 1e-3 with the same variance, held against
    layer_norm_ref like the cells' shapes; and exactly constant bf16 rows,
    whose result is y = b exactly. Those are held to b and not to
    layer_norm_ref: F.layer_norm's float32 mean of such a row is an ulp off
    at some widths (40, 192 and 768 on the H100), which rstd = 1e6 at eps
    1e-12 turns into |t| of about 0.03."""
    dev = _card()
    failures = []
    for i, C in enumerate((128, 192, 256, 512, 768, 1536, 3072, 40)):
        w, b = _params(C, seed=400 + i, device=dev)
        g = torch.Generator().manual_seed(500 + i)
        noise = 3e-4 * torch.randn(1000, C, generator=g)
        level = 0.3 + torch.randint(-8, 9, (1000, 1), generator=g) / 16.0
        for tag, x in (("bf16 near 0", noise.to(dev, BF16)),
                       ("f32 near 1e-3", (1e-3 + noise).to(dev, F32))):
            share, worst, at = _compare(x, w, b, eps)
            if _failed(share, worst):
                failures.append(f"C={C} {tag}: {share:.2e} of the elements differ, "
                                f"{worst:.3f} of the bound at {at}")
        constant = level.expand(1000, C).contiguous().to(dev, BF16)
        y = ln_mod._launch(constant, w, b, eps)
        if not torch.equal(y, b.to(BF16).expand(1000, C)):
            failures.append(f"C={C}: constant rows do not give y = b")
    torch.cuda.synchronize()
    assert not failures, "\n".join(failures)


@pytest.mark.card
def test_kernel_against_the_float32_result_before_rounding():
    """Within half a bf16 ulp of F.layer_norm's float32 result, plus float32
    rounding of the terms."""
    dev = _card()
    for i, (C, rows) in enumerate([(128, 9000), (192, 9000), (256, 9000), (384, 4000),
                                   (768, 4000), (1536, 2000), (3072, 1000), (40, 500)]):
        x = _input(rows, C, BF16, seed=200 + i, device=dev)
        w, b = _params(C, seed=300 + i, device=dev)
        got = ln_mod._launch(x, w, b, 1e-6).float()
        t = F.layer_norm(x.float(), (C,), None, None, 1e-6)
        y32 = t * w + b
        slack = 1e-5 * ((t * w).abs() + b.abs()) + 1e-6
        excess = ((got - y32).abs() - 0.5 * ln_mod.bf16_ulp(y32) - slack).max().item()
        assert excess <= 0, f"C={C}: beyond half an ulp plus float32 rounding by {excess}"


@pytest.mark.card
def test_every_bf16_norm_of_an_inference_pass_launches_the_kernel():
    """One bfloat16 InferenceEngine.infer_videos pass of a small SOC on the
    card: the kernel launches once for each call of a bfloat16 LayerNorm, and
    the plain version runs once for each call of a float32 one (txt_proj)."""
    from neurips2023_soc_torch.inference import InferenceEngine
    from neurips2023_soc_torch.models.soc import SOC

    dev = _card()
    model = init_weights(SOC(backbone_name="video-swin-t", d_model=64, num_queries=5,
                             dim_feedforward=128, enc_layers=2, dec_layers=2,
                             voc_enc_layers=1, voc_dec_layers=1,
                             text_encoder_type="roberta-tiny", dtype=BF16,
                             swin_attn_impl="pallas"),
                         torch.Generator().manual_seed(0)).eval()
    calls = {BF16: 0, F32: 0}

    def count(mod, args):
        calls[mod.dtype] += 1

    hooks = [m.register_forward_pre_hook(count) for m in model.modules()
             if isinstance(m, LayerNorm)]
    engine = InferenceEngine(model, device=dev, text_encoder_type="roberta-tiny",
                             text_bucket=8, size_buckets=((96, 128),), time_buckets=(4, 8))
    rng = np.random.RandomState(1)
    items = [dict(frames=rng.randint(0, 256, (t, 96, 128, 3)).astype(np.uint8), texts=texts)
             for t, texts in ((6, ["a red car"]), (4, ["the dog", "a man", "a cat"]))]
    layer_norm.launches = layer_norm.plain_calls = 0
    results = list(engine.infer_videos(iter(items), depth=1))
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    assert [len(r) for r in results] == [1, 3]
    assert calls[BF16] > 0 and calls[F32] > 0
    assert layer_norm.launches == calls[BF16]
    assert layer_norm.plain_calls == calls[F32]
