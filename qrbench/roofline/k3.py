"""K3, the lane-major damped LM step (``ops/lm_step.py`` → ``lm_step.cu``):
one launch a step over ``points`` lanes of ``problems`` problems."""


def cost(points: int, problems: int = 1, bl: int = 2, bc: int = 1, m2: int = 5,
         itemsize: int = 4):
    """(bytes, operations) of one step: the left ``[bl, bc, N]``, right
    ``[bl, m2, N]`` and residual ``[bl, N]`` read and the step ``[bc·N +
    m2]`` written, with λ; per point its ``bc`` Householder steps on its
    ``bl + bc`` rows and ``m2 + 1`` columns, the absorb of its rows into its
    thread's carry and its back-substitution (the merges of the carries
    are not counted)."""
    nbytes = ((bl * bc + bl * m2 + bl) * points + bc * points + m2 + 1) * itemsize
    br = bl + bc
    point = sum(2 * (br - j) + sum(4 * (br - j) + 1 for _ in range(bc - j - 1 + m2 + 1))
                for j in range(bc))
    panel = sum(2 * bl + 3 + (m2 - j) * (4 + 4 * bl) for j in range(m2))
    back = bc * 2 * m2 + bc * bc
    return problems * nbytes, problems * (point + panel + back) * points
