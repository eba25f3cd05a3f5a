"""Host ms per video of the engine's unpacking of the fetched masks into the
public contract (np.unpackbits, crop): the program's soc.engine.unpack spans,
summed, over the soc.engine.collect spans (one a video)."""


def read(ctx):
    if ctx.trace is None:
        return None
    ranges = ctx.trace.ranges
    unpack = [b - a for n, a, b in ranges if n == "soc.engine.unpack"]
    videos = sum(n == "soc.engine.collect" for n, _, _ in ranges)
    return 1e3 * sum(unpack) / videos if unpack and videos else None
