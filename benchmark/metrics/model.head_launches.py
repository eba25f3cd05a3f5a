"""Device operations (kernels, copies, fills) per head call: those of the
trace whose launch lies inside one of the program's soc.head spans, over the
number of those spans."""
import bisect


def read(ctx):
    if ctx.trace is None:
        return None
    heads = sorted((a, b) for n, a, b in ctx.trace.ranges if n == "soc.head")
    if not heads:
        return None
    union = []
    for a, b in heads:
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    starts = [a for a, _ in union]
    launched = 0
    for _, _, _, at in ctx.trace.kernels:
        i = bisect.bisect_right(starts, at) - 1
        launched += i >= 0 and at <= union[i][1]
    return launched / len(heads)
