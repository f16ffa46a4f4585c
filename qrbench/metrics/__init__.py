"""Per-layer metrics, each ``read(ctx)`` over the traced run: the window
timed by the host clock (``ctx.records``), the traced window
(``ctx.traced``, ``ctx.trace``), the caller (``ctx.caller``) and the card's
name (``ctx.kind``).  A reader that finds nothing to read returns None."""


def mean(xs):
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


def per_call_seconds(ctx, annotation: str, name_parts) -> float:
    """The device seconds of the kernels whose name holds one of
    ``name_parts`` and whose launch lies in ``annotation``, per traced call
    (None where there are none)."""
    ops = [op for op in ctx.trace.kernels(annotation)
           if any(part in op[0] for part in name_parts)]
    if not ops or not ctx.traced:
        return None
    return sum(t - s for _, _, s, t, _ in ops) / 1e6 / len(ctx.traced)
