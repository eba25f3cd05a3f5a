"""Host ms per video of InferenceEngine._dispatch_video (upload, launch
of the backbone, the heads and the finalize; it never waits for the card),
from the benchmark's span around the bound method."""


def read(ctx):
    d = ctx.spans.durations.get("engine.dispatch")
    return 1e3 * sum(d) / len(d) if d else None
