"""From the process's start to the first timed call: imports, the card's
start, the inputs, the solver's analysis, every kernel build or load and
every capture."""


def compute(ctx):
    return ctx.setup_s
