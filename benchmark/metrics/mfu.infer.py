"""Model FLOPs the window's videos need (real frames, work/model.py) over the
traced window's seconds times the bf16 dense peak."""
from benchmark.readers import mfu


def read(ctx):
    return mfu(ctx)
