"""Share of the traced window with no kernel running on the card."""
from benchmark.readers import idle


def read(ctx):
    return idle(ctx)
