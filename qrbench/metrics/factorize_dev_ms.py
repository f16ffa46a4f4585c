"""Device milliseconds of ``factorize_values`` a call: the union of the
intervals of the device operations launched inside ``qrbench.factorize``,
over the traced calls."""


def read(ctx):
    ops = [op for op in ctx.trace.ops if op[4] == "qrbench.factorize"]
    if not ops or not ctx.traced:
        return None
    busy, end = 0.0, float("-inf")
    for _, _, s, t, _ in sorted(ops, key=lambda op: op[2]):
        if t > end:
            busy += t - max(s, end)
            end = t
    return busy / 1e3 / len(ctx.traced)
