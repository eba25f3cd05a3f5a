"""Host ms per video of the engine's uploads: the program's soc.engine.upload
spans (the tokens, the staging fill and copy, the normalize; one a chunk),
summed, over the soc.engine.dispatch spans (one a video)."""


def read(ctx):
    if ctx.trace is None:
        return None
    ranges = ctx.trace.ranges
    upload = [b - a for n, a, b in ranges if n == "soc.engine.upload"]
    videos = sum(n == "soc.engine.dispatch" for n, _, _ in ranges)
    return 1e3 * sum(upload) / videos if upload and videos else None
