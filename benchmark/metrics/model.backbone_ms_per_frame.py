"""Device ms per padded frame of the kernels launched inside
SOC.backbone_features (Video-Swin: K3 and the plain PyTorch around it)."""
from benchmark.readers import kernel_ms_per


def read(ctx):
    frames = sum(c["frames"] for c in ctx.spans.calls.get("model.backbone_features", []))
    return kernel_ms_per(ctx, ["model.backbone_features"], frames)
