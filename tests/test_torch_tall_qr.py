"""The R-only tall-skinny QR of the ragged block-angular step's bottom
(``ops.tall_qr``, kernel K5).

On the CPU :func:`r_and_qtb` runs its plain version, the kernel's panels,
tiles and tree levels in torch.  Here it is held against
``torch.linalg.qr(mode="r")`` of ``[A | b]`` in float64 (R up to the signs
of its rows, y2 with them) and x2 = R2⁻¹y2 against ``torch.linalg.lstsq``,
in float32 and float64, at a width that is not a whole number of panels
(BAL's 468 = 14·32 + 20), rows that are not a whole number of tiles, a
tree of one to three levels, zero rows (a whole tile of them), fewer rows
than columns, no rows, columns zero in some tiles (τ = 0) and a column
zero throughout (A rank-deficient: R is not unique, its Gram is checked).
The launcher's arguments are read through a tensor that reports a card,
and the operands the wrapper refuses are listed.

The ``cuda`` cases run on the card with ``python -m pytest --noconftest -m
cuda tests/test_torch_tall_qr.py``: K5 against the plain version on the
same card and against a float64 solve, at small shapes and at BAL
Venice-52's 694,814 × 469 bottom (R's Gram residual, x2); two calls
bitwise equal; a replayed CUDA graph bitwise equal to an eager call; the
operands the kernel refuses; the library's plan equal to the wrapper's.
"""
import numpy as np
import pytest
import torch

from qrkit_tpu_torch import profiling
from qrkit_tpu_torch.ops import _build
from qrkit_tpu_torch.ops import tall_qr as tq

DTYPES = [torch.float32, torch.float64]
DT_IDS = ["f32", "f64"]
# name -> (m, n, how the operand is made): rows, R2's order
SHAPES = {
    "bal_width": (700, 468, "normal"),  # 14 panels of 32 and one of 20; 3 tiles, one level
    "short_tile": (256 * 9 + 7, 37, "normal"),  # 10 tiles, the last of 7 rows; two levels
    "three_levels": (256 * 70 + 100, 20, "normal"),  # 71 tiles: 9, 2, 1
    "zero_rows": (1100, 40, "zero_rows"),  # a whole tile of zero rows, and a few more
    "zero_columns": (600, 50, "zero_columns"),  # columns 7 and 32 zero in some tiles: tau = 0
    "zero_column": (600, 50, "zero_column"),  # column 9 zero: A rank-deficient, R not unique
    "wide": (20, 45, "normal"),  # fewer rows than columns
    "one_row": (1, 6, "normal"),
    "no_rows": (0, 5, "normal"),
}
TOL = {torch.float32: 2e-5, torch.float64: 1e-11}  # relative to the largest entry of R


def operand(m, n, how, dtype, device="cpu", seed=0):
    """``[A | b] [m, n + 1]``: normal entries, columns scaled over four
    decades (a Jacobian's columns differ in scale)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, n + 1)) * np.logspace(0, 2, n + 1)
    if how == "zero_rows":
        a[256:512] = 0.0
        a[700:703] = 0.0
    if how == "zero_columns":
        a[:512, 7] = 0.0
        a[256:600, 32] = 0.0
    if how == "zero_column":
        a[:, 9] = 0.0
    return torch.as_tensor(a, dtype=dtype, device=device)


def signed_rows(R, ref):
    """R's rows with the signs that make its diagonal agree with ``ref``'s."""
    k = min(R.shape[0], ref.shape[0], ref.shape[1])
    d, dr = torch.diagonal(R[:k, :k]), torch.diagonal(ref[:k, :k])
    s = torch.where((d < 0) != (dr < 0), -1.0, 1.0).to(R.dtype)
    return R[:k] * s[:, None]


def check_against_library(a, R2, y2, tol):
    """``[R2 | y2]``'s Gram against ``[A | b]``'s (all but the residual's
    entry); where A's leading columns have full rank, R2 and y2 against
    ``torch.linalg.qr(mode="r")`` of ``a`` in float64 (up to the signs of
    R's rows, where R is unique) and, with m ≥ n, x2 against
    ``torch.linalg.lstsq``."""
    m, n = a.shape[0], a.shape[1] - 1
    a64 = a.double().cpu()
    got = torch.cat([R2.double().cpu(), y2.double().cpu()[:, None]], dim=1)
    gram, want = got.mT @ got, a64.mT @ a64
    gscale = float(want.abs().max()) if m else 1.0
    torch.testing.assert_close(gram[:, :n], want[:, :n], rtol=0, atol=10 * tol * gscale)
    k = min(m, n)
    assert not got[k:].any(), "R2's rows past m must be zero"
    assert torch.equal(torch.triu(R2), R2)
    if int(torch.linalg.matrix_rank(a64[:, :k])) < k:
        return
    ref = torch.linalg.qr(a64, mode="r")[1]
    scale = float(ref.abs().max()) if ref.numel() else 1.0
    torch.testing.assert_close(signed_rows(got, ref)[:k], ref[:k, :], rtol=0, atol=tol * scale)
    if m >= n:
        x2 = torch.linalg.solve_triangular(R2.double().cpu(), y2.double().cpu()[:, None], upper=True)
        sol = torch.linalg.lstsq(a64[:, :n], a64[:, n:]).solution
        xtol = 1e3 * tol if a.dtype == torch.float32 else 1e-8
        torch.testing.assert_close(x2, sol, rtol=0, atol=xtol * float(sol.abs().max()))


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_plain_matches_the_library_qr(name, dtype):
    m, n, how = SHAPES[name]
    a = operand(m, n, how, dtype)
    R2, y2 = tq.r_and_qtb(a.clone())
    assert R2.shape == (n, n) and y2.shape == (n,) and R2.dtype == y2.dtype == dtype
    check_against_library(a, R2, y2, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_plain_overwrites_its_operand_only(dtype):
    """The operand is the step's own temporary: overwritten, and a row
    stride wider than the row is read through (a view of a wider
    buffer); two calls on equal operands give the same bits."""
    m, n, _ = SHAPES["short_tile"]
    a = operand(m, n, "normal", dtype)
    wide = torch.zeros((m, n + 4), dtype=dtype)
    wide[:, 2:n + 3] = a
    R2, y2 = tq.r_and_qtb(wide[:, 2:n + 3])
    assert not torch.equal(wide[:, 2:n + 3], a)
    assert not wide[:, :2].any() and not wide[:, n + 3:].any()
    again = tq.r_and_qtb(a.clone())
    assert torch.equal(R2, again[0]) and torch.equal(y2, again[1])
    check_against_library(a, R2, y2, TOL[dtype])


def test_plan():
    """BAL Venice-52's bottom: 2,715 tiles, a tree of 340, 43, 6 and 1
    groups, 15 panels, 75 launches an iteration."""
    assert tq.plan(694_814, 468) == tq.Plan(2715, 4, 15, 75, 2715 + 340)
    assert tq.plan(0, 5) == tq.Plan(1, 0, 1, 1, 2)
    assert tq.plan(256, 32) == tq.Plan(1, 0, 1, 1, 2)
    assert tq.plan(257, 33) == tq.Plan(2, 1, 2, 4, 3)


# --- the kernel's route --------------------------------------------------------------------

class _OnCuda1(torch.Tensor):
    """A CPU tensor that reports cuda:1, so the wrapper takes its kernel path."""

    @property
    def device(self):
        return torch.device("cuda", 1)


@pytest.fixture
def launch_recorder(monkeypatch):
    """The K5 library swapped for a recorder of (name, args); the stream of
    cuda:N reads as 1000 + N.  The launch counters are restored after."""
    calls = []

    class Library:
        def __getattr__(self, name):
            def record(*args):
                calls.append((name, args))
                return 0

            record.__name__ = name
            return record

    monkeypatch.setattr(_build, "load_tall_qr", lambda: Library())
    monkeypatch.setattr(_build, "current_stream", lambda device: 1000 + device)
    for fn in profiling._KERNEL_WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", 0)
    _build.tall_qr_launcher.cache_clear()
    yield calls
    _build.tall_qr_launcher.cache_clear()


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_kernel_path_reaches_its_launcher(launch_recorder, dtype):
    """An operand on cuda:1 reaches the launcher with ordinal 1, its data
    and row stride (a view of a wider buffer, no copy), m, n, the outputs,
    the scratch and its blocks as the plan sizes them, and cuda:1's
    stream; the plan's launches are counted."""
    m, n = 3000, 54
    wide = torch.zeros((m, n + 9), dtype=dtype)
    a = wide[:, 3:n + 4].as_subclass(_OnCuda1)
    R2, y2 = tq._r_and_qtb_kernel(a)
    p = tq.plan(m, n)
    ((name, args),) = launch_recorder
    assert name == f"qrk_tall_qr_{'f32' if dtype == torch.float32 else 'f64'}"
    assert args[:5] == (1, a.data_ptr(), n + 9, m, n) and args[-1] == 1001
    assert args[5:7] == (R2.data_ptr(), y2.data_ptr()) and args[8] == p.scratch_blocks
    assert R2.shape == (n, n) and y2.shape == (n,)
    assert profiling.launch_counts()["tall_qr"] == p.launches == 2 * (1 + 2)  # 12 tiles: 2, 1


def test_cpu_never_builds(monkeypatch):
    """A CPU tensor runs the plain version: nothing is built or counted."""
    monkeypatch.setattr(_build, "load_tall_qr", lambda: pytest.fail("built on the CPU"))
    before = profiling.launch_counts()
    tq.r_and_qtb(operand(300, 10, "normal", torch.float64))
    assert profiling.launch_counts() == before


BAD = {
    "int": lambda a: a.long(),
    "half": lambda a: a.half(),
    "bfloat16": lambda a: a.bfloat16(),
    "one column": lambda a: a[:, :1],
    "vector": lambda a: a[:, 0],
    "transposed": lambda a: a.mT.contiguous().mT,
    "strided columns": lambda a: a.repeat(1, 2)[:, ::2],
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_refuses_bad_operands(case):
    a = BAD[case](operand(40, 6, "normal", torch.float64))
    with pytest.raises(ValueError):
        tq.r_and_qtb(a)


def test_the_kernel_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        tq._r_and_qtb_kernel(operand(40, 6, "normal", torch.float32))


# --- on the card --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


BAL_ROWS, BAL_N = 694_814, 468  # Venice-52's bottom: 2 x 347,173 observations + 468 damping rows


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_cuda_matches_plain_and_library(cuda_device, name, dtype):
    m, n, how = SHAPES[name]
    a = operand(m, n, how, dtype, cuda_device)
    before = profiling.launch_counts()["tall_qr"]
    R2, y2 = tq.r_and_qtb(a.clone())
    pR2, py2 = tq._r_and_qtb_plain(a.clone())
    torch.cuda.synchronize()
    assert profiling.launch_counts()["tall_qr"] == before + tq.plan(m, n).launches
    scale = float(pR2.abs().max()) if n and m else 1.0
    torch.testing.assert_close(R2, pR2, rtol=0, atol=TOL[dtype] * scale)
    torch.testing.assert_close(y2, py2, rtol=0, atol=TOL[dtype] * max(scale, float(py2.abs().max())))
    check_against_library(a, R2, y2, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_cuda_bal_shape(cuda_device, dtype):
    """BAL's bottom: R's Gram residual ‖R2ᵀR2 − JᵀJ‖ / ‖JᵀJ‖ (float64 from
    the operand's values) and x2 against a float64 least-squares solve;
    the plain version on the same card agrees."""
    a = operand(BAL_ROWS, BAL_N, "normal", dtype, cuda_device, seed=3)
    R2, y2 = tq.r_and_qtb(a.clone())
    pR2, _ = tq._r_and_qtb_plain(a.clone())
    a64 = a.double()
    J = a64[:, :BAL_N]
    gram = J.mT @ J
    got = R2.double().mT @ R2.double()
    res = float(torch.linalg.matrix_norm(got - gram) / torch.linalg.matrix_norm(gram))
    x2 = torch.linalg.solve_triangular(R2.double(), y2.double()[:, None], upper=True)
    want = torch.linalg.lstsq(J, a64[:, BAL_N:]).solution
    xerr = float((x2 - want).abs().max() / want.abs().max())
    perr = float((R2.double() - pR2.double()).abs().max() / pR2.double().abs().max())
    lim = {torch.float32: (1e-5, 1e-3, 1e-4), torch.float64: (1e-13, 1e-10, 1e-11)}[dtype]
    assert res < lim[0] and xerr < lim[1] and perr < lim[2], (res, xerr, perr)


@pytest.mark.cuda
def test_cuda_two_calls_and_a_replayed_graph_give_the_same_bits(cuda_device):
    m, n, _ = SHAPES["three_levels"]
    a = operand(m, n, "normal", torch.float32, cuda_device)
    one, two = tq.r_and_qtb(a.clone()), tq.r_and_qtb(a.clone())
    static = a.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tq.r_and_qtb(static.clone())  # warm: the library, the kernel's attributes
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    work = static.clone()
    with torch.cuda.graph(graph):
        work.copy_(static)
        out = tq.r_and_qtb(work)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], one[0]) and torch.equal(out[1], one[1])
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BAD))
def test_cuda_refuses_bad_operands(cuda_device, case):
    a = BAD[case](operand(40, 6, "normal", torch.float32, cuda_device))
    with pytest.raises(ValueError):
        tq.r_and_qtb(a)


@pytest.mark.cuda
def test_cuda_plan_is_the_library_plan(cuda_device):
    for m, n in [(0, 5), (1, 1), (256, 32), (257, 33), (BAL_ROWS, BAL_N), (10 ** 7, 9)]:
        assert _build.tall_qr_plan(m, n) == tuple(tq.plan(m, n))
