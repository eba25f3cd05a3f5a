"""Host ms to issue one expression's head: the mean duration of the program's
soc.head spans (SOC.head: RoBERTa, fusion, the deformable transformer, VOC
and the mask head, launched and not waited for)."""


def read(ctx):
    if ctx.trace is None:
        return None
    heads = [b - a for n, a, b in ctx.trace.ranges if n == "soc.head"]
    return 1e3 * sum(heads) / len(heads) if heads else None
