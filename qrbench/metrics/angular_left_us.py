"""Microseconds a step of the block-angular step's left on the device,
each LM iteration of the traced fits: from the step's entry to its bottom
assembled (the L2 marks ``"step"`` to ``"bottom"``): the Jacobian blocks, each
bucket's point QR, its Q1ᵀ on the compact camera slabs and the rhs, and
the scatter of the complement rows into the bottom."""
from ..step_marks import part_us


def read(ctx):
    return part_us("step", "bottom")
