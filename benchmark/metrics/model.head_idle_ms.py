"""Card-idle ms per head call: the window's idle gaps (no kernel, copy or
fill running) whose midpoint lies inside one of the program's soc.head spans,
the rule by which Trace.idle_gaps names a gap, summed in one sorted sweep,
over the number of those spans."""
import bisect


def read(ctx):
    trace = ctx.trace
    if trace is None:
        return None
    heads = sorted((a, b) for n, a, b in trace.ranges if n == "soc.head")
    if not heads:
        return None
    union = []
    for a, b in heads:
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    starts = [a for a, _ in union]
    lo, hi = trace.window
    gaps, end = [], lo
    for _, ts, dur, _ in trace.kernels:
        if ts > end:
            gaps.append((end, min(ts, hi)))
        end = max(end, ts + dur)
    if end < hi:
        gaps.append((end, hi))
    idle = 0.0
    for a, b in gaps:
        if b <= a:
            continue
        i = bisect.bisect_right(starts, (a + b) / 2) - 1
        if i >= 0 and (a + b) / 2 <= union[i][1]:
            idle += b - a
    return 1e3 * idle / len(heads)
