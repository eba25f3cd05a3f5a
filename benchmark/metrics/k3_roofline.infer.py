"""K3 (Swin window attention, wattn_* kernels) against its least time at
the shapes of the calls Video-Swin made."""
from benchmark.readers import roofline
from benchmark.work.kernels import window_attention


def read(ctx):
    return roofline(ctx, "k3.call", "wattn_", window_attention)
