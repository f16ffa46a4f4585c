"""The window's seconds over the calls completed, in ms (each call ends in
``torch.cuda.synchronize()``)."""


def compute(ctx):
    return ctx.window_s / len(ctx.records) * 1e3
