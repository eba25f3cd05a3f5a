"""Host ms per video that the engine waits for the card: the program's
soc.engine.wait spans (the event behind a video's copies), summed, over the
soc.engine.collect spans (one a video)."""


def read(ctx):
    if ctx.trace is None:
        return None
    ranges = ctx.trace.ranges
    wait = [b - a for n, a, b in ranges if n == "soc.engine.wait"]
    videos = sum(n == "soc.engine.collect" for n, _, _ in ranges)
    return 1e3 * sum(wait) / videos if wait and videos else None
