"""K1 (MSDA forward, msda_fwd_* kernels) against its least time at the
shapes of the calls the deformable transformer made, in the engine cells."""
from benchmark.readers import roofline
from benchmark.work.kernels import msda_fwd


def read(ctx):
    return roofline(ctx, "k1.call", "msda_fwd", msda_fwd)
