"""Where the port's entry points put their data, and which geometries the
banded kernels' gates admit.

* Host data (NumPy, ``SparseCSR``) given without ``device=`` goes to CUDA:
  here, with no card, every such entry point raises PyTorch's own error
  rather than running on the CPU.  A tensor input keeps its device.
* The shared-memory sizes the solvers' gates read (``chain_smem_bytes``,
  ``apply_w_smem_bytes`` against ``SMEM_LIMIT``) admit the geometries the
  main paths give the kernels: config 3's segment chains (48×8), plain chain
  (48×8), boundary chain (88×32) and W apply (ko = 8), and the banded
  ellipse stack's 4×1 chain, in fp32 and fp64, computed from the solvers'
  own analyses on the CPU; and every geometry the earlier kernels' 48 KB
  bound admitted.
"""
import numpy as np
import pytest
import torch

import qrkit_tpu_torch as qt
from qrkit_tpu_torch import _device, convert
from qrkit_tpu_torch.examples import ellipse
from qrkit_tpu_torch.ops import banded as bk
from qrkit_tpu_torch.parallel.tsqr import TSQRDenseQR

DEV = torch.device("cpu")
# what PyTorch raises for a CUDA tensor without a card: AssertionError on a
# CPU-only build, RuntimeError on a CUDA build
NO_CARD = (AssertionError, RuntimeError)
ELLIPSE = ellipse.Ellipse(7.5, 2.0, 17.0, 23.0, 0.23)


def banded_matrix(rng, nb, br, bc, ov):
    """Row-sorted banded matrix: nb blocks of br×bc overlapping ov columns
    (``chip_smoke.banded_matrix``, BASELINE config 3's layout)."""
    step = bc - ov
    ncols = step * nb + ov
    i, r, c = np.meshgrid(np.arange(nb), np.arange(br), np.arange(bc), indexing="ij")
    rows, cols = (i * br + r).ravel(), (i * step + c).ravel()
    keep = cols < ncols
    vals = rng.uniform(0.5, 5.0, size=rows.size)
    return qt.SparseCSR.from_triplets(rows[keep], cols[keep], vals[keep], (br * nb, ncols))


def test_resolve_defaults_to_cuda():
    assert _device.resolve(None) == torch.device("cuda")
    assert _device.resolve("cpu") == DEV
    assert qt.BandedBlockedQR().device.type == "cuda"
    assert qt.SegmentedBandedQR().device.type == "cuda"
    assert qt.BandedBlockedQR(device="cpu").device == DEV


def _host_entry_points():
    rng = np.random.default_rng(0)
    blocks = rng.uniform(0.5, 5.0, size=(6, 3, 2))
    soa = np.ascontiguousarray(blocks.transpose(1, 2, 0).reshape(6, 6))
    i, r, c = np.meshgrid(np.arange(6), np.arange(3), np.arange(2), indexing="ij")
    bd = qt.SparseCSR.from_triplets((i * 3 + r).ravel(), (i * 2 + c).ravel(), blocks.ravel(), (18, 12))
    dense = rng.normal(size=(9, 4))
    pts = ellipse.ellipse_points(ELLIPSE, 40)
    band = banded_matrix(rng, 40, 10, 4, 2)
    return {
        "from_soa": lambda: qt.BlockDiagonal.from_soa(soa, 3, 2),
        "from_dense_batch": lambda: qt.BlockDiagonal.from_dense_batch(blocks),
        "from_block_diagonal_pattern": lambda: qt.BlockDiagonal.from_block_diagonal_pattern(bd, 3, 2),
        "from_sparse_matrix": lambda: qt.BlockDiagonal.from_sparse_matrix(bd, 2),
        "block_diagonal_from_numpy": lambda: convert.block_diagonal_from_numpy(18, 12, blocks=blocks),
        "dense_qr_from_numpy": lambda: convert.dense_qr_from_numpy(
            {"Y": np.eye(4), "T": np.eye(4), "R": np.eye(4)}),
        "dense_compute": lambda: qt.DenseColPivQR().compute(dense),
        "tsqr_compute": lambda: TSQRDenseQR(2).compute(dense),
        "banded_compute": lambda: qt.BandedBlockedQR(suggested_block_cols=4).compute(band),
        "segmented_compute": lambda: qt.SegmentedBandedQR(4, 8).compute(band),
        "ellipse_fitting": lambda: ellipse.EllipseFitting(pts),
        "fit_ellipse": lambda: ellipse.fit_ellipse(pts),
        "fit_ellipse_batch": lambda: ellipse.fit_ellipse_batch(pts[None]),
    }


HOST_ENTRY_POINTS = sorted(_host_entry_points())


@pytest.mark.parametrize("name", HOST_ENTRY_POINTS)
def test_host_input_without_device_goes_to_cuda(name):
    """Without ``device=``, host data goes to the card: with one, the
    entry point runs there; without one, it raises PyTorch's own error and
    never falls back to the CPU."""
    call = _host_entry_points()[name]
    if torch.cuda.is_available():
        out = call()
        out = out[0] if isinstance(out, tuple) else out
        dev = out.device if hasattr(out, "device") else getattr(out, "_device", None)
        assert dev is None or dev.type == "cuda"
        return
    with pytest.raises(NO_CARD):
        call()


@pytest.mark.parametrize("kind", ["from_dense_batch", "from_soa", "dense", "tsqr", "lm"])
def test_tensor_input_keeps_its_device(kind):
    rng = np.random.default_rng(1)
    if kind == "from_dense_batch":
        t = torch.as_tensor(rng.uniform(0.5, 5.0, size=(4, 3, 2)))
        assert qt.BlockDiagonal.from_dense_batch(t).device == DEV
    elif kind == "from_soa":
        t = torch.as_tensor(rng.uniform(0.5, 5.0, size=(6, 4)))
        assert qt.BlockDiagonal.from_soa(t, 3, 2, dtype=torch.float32).device == DEV
    elif kind == "dense":
        qr = qt.DenseColPivQR().compute(torch.as_tensor(rng.normal(size=(7, 3))))
        assert qr.solve(torch.ones(7, dtype=torch.float64)).device == DEV
    elif kind == "tsqr":
        qr = TSQRDenseQR(2).compute(torch.as_tensor(rng.normal(size=(12, 3))))
        assert qr.solve(torch.ones(12, dtype=torch.float64)).device == DEV
    else:
        from qrkit_tpu_torch import lm

        res = lm.levenberg_marquardt(
            lambda x: x - 1.0, lambda x, r, lam: -r / (1.0 + lam),
            torch.zeros(3, dtype=torch.float64), lm.LMConfig(max_iters=5),
        )
        assert res.x.device == DEV


@pytest.fixture(scope="module")
def config3():
    """BASELINE config 3: 2,499 blocks of 40×8 overlapping 4."""
    return banded_matrix(np.random.default_rng(0), 2499, 40, 8, 4)


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])


@DTYPES
def test_gates_admit_config3_segmented(config3, dtype):
    """Segment chains (B3) 48×8, W apply (B4) at ko = 8 and the boundary
    chain (B5) 88×32 all take their kernels; the narrow ones the register
    kernels, the boundary chain the shared-memory kernel."""
    seg = qt.SegmentedBandedQR(8, 32, device=DEV, dtype=dtype).analyze_pattern(config3)
    item = torch.empty((), dtype=dtype).element_size()
    kw = seg._kw
    assert (kw["max_active"], kw["max_cols"]) == (48, 8)
    assert seg._kernel_gate and seg._p2w is not None and seg._chain_kernel is not None
    st = seg._p2w["statics"]
    assert st["ko"] == 8
    assert bk.register_shape(48, 8, item) == (2, 8)
    assert bk.chain_smem_bytes(48, 8, kw["max_carry"], item) <= bk.SMEM_LIMIT
    assert bk.apply_w_smem_bytes(st["ma"], st["mc"], st["ko"], st["wrows"], item) <= bk.SMEM_LIMIT
    ckw = seg._chain_kw
    assert (ckw["max_active"], ckw["max_cols"]) == (88, 32)
    assert bk.register_shape(88, 32, item) is None
    assert bk.chain_smem_bytes(88, 32, ckw["max_carry"], item) <= bk.SMEM_LIMIT


@DTYPES
def test_gates_admit_config3_plain_chain(config3, dtype):
    plain = qt.BandedBlockedQR(suggested_block_cols=8, device=DEV, dtype=dtype).analyze_pattern(config3)
    assert plain._chain_kernel == dict(mca=8, me=8, ci=4, ci0=4)
    assert (plain._max_active, plain._max_cols) == (48, 8)


@DTYPES
def test_gates_admit_ellipse_banded_chain(dtype):
    """The banded ellipse stack's left solver (3×1 blocks, no overlap): a
    4×1 chain on the register kernel."""
    n = 64
    sp = qt.SparseCSR.from_triplets(
        np.arange(3 * n), np.repeat(np.arange(n), 3), np.ones(3 * n), (3 * n + 5, n)
    )
    q = qt.BandedBlockedQR(3, 1, 0, 1, device=DEV, dtype=dtype).analyze_pattern(sp)
    assert q._chain_kernel == dict(mca=1, me=1, ci=1, ci0=1)
    assert (q._max_active, q._max_cols) == (4, 1)
    assert bk.register_shape(4, 1, torch.empty((), dtype=dtype).element_size()) == (1, 1)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_gates_never_shrink(itemsize):
    """Every geometry within the earlier kernels' 48 KB (panel, carry,
    reflector and a scalar; W, window, Y and τ) still takes a kernel."""
    old_limit = 48 * 1024
    for ma in (1, 2, 3, 4, 31, 32, 33, 48, 64, 65, 88, 96, 97, 128, 200, 400, 700):
        for mc in (1, 2, 7, 8, 9, 16, 31, 32, 33, 64, 100):
            for mca in sorted({1, max(1, ma // 2), ma}):
                if (ma * mc + mca * mc + ma + 1) * itemsize <= old_limit:
                    assert bk.chain_smem_bytes(ma, mc, mca, itemsize) <= bk.SMEM_LIMIT, (ma, mc, mca)
            for ko in (1, 8, 33, 200):
                wrows = 2 * ma + 8
                if (wrows * ko + ma * ko + ma * mc + mc) * itemsize <= old_limit:
                    assert bk.apply_w_smem_bytes(ma, mc, ko, wrows, itemsize) <= bk.SMEM_LIMIT
