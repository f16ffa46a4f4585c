"""Microseconds a step of the block-angular step's right on the device,
each LM iteration of the traced fits: from the bottom assembled to its
TSQR's factorization and Qᵀ on the rhs done (the L2 marks ``"bottom"`` to
``"tsqr"``)."""
from ..step_marks import part_us


def read(ctx):
    return part_us("bottom", "tsqr")
