"""Device ms per padded frame of the kernels launched inside the program's
soc.backbone.stage2 spans (the PatchMerging into stage 2, its 18 blocks with
K3, norm2), over the frames of the SOC.backbone_features calls; nothing
where the program has no stage spans."""
from benchmark.readers import kernel_ms_per

STAGE = "soc.backbone.stage2"


def read(ctx):
    # Trace.kernel_s cannot take a range name the trace lacks
    if ctx.trace is None or not any(n == STAGE for n, _, _ in ctx.trace.ranges):
        return None
    frames = sum(c["frames"] for c in ctx.spans.calls.get("model.backbone_features", []))
    return kernel_ms_per(ctx, [STAGE], frames)
