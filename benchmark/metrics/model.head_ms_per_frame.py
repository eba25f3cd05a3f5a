"""Device ms per padded frame and expression of the kernels launched inside
SOC.head (RoBERTa, fusion, deformable transformer with K1, VOC, mask head)."""
from benchmark.readers import kernel_ms_per


def read(ctx):
    frames = sum(c["frames"] for c in ctx.spans.calls.get("model.head", []))
    return kernel_ms_per(ctx, ["model.head"], frames)
