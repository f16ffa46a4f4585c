"""Port host layer (sparse / analysis / plan / native) against qrkit_tpu.

Structure analysis is integer pattern work, so the port must reproduce the
reference package exactly: equal permutation indices, equal block plans,
equal extracted panels — with the native engine and with the NumPy
fallback.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import qrkit_tpu._native as jnative
from qrkit_tpu import analysis as janalysis
from qrkit_tpu import sparse as jsparse
from qrkit_tpu.containers import BlockDiagonal as JBlockDiagonal

import qrkit_tpu_torch._native as tnative
from qrkit_tpu_torch import analysis as tanalysis
from qrkit_tpu_torch import plan as tplan
from qrkit_tpu_torch import sparse as tsparse
from qrkit_tpu_torch.containers import BlockDiagonal

from generators import block_diagonal_matrix, overlapping_block_diagonal_matrix

DEV = torch.device("cpu")  # the CPU tests name the device: entry points default to CUDA


def _port(m):
    return tsparse.SparseCSR(m.shape, m.indptr, m.indices, m.data)


def _set_native(monkeypatch, native):
    if not native:
        monkeypatch.setattr(jnative, "_LIB", None)
        monkeypatch.setattr(jnative, "_TRIED", True)
        monkeypatch.setattr(tnative, "available", lambda: False)
    elif not (jnative.available() and tnative.available()):
        pytest.skip("native library not built (make -C native)")


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("permute_rows", [False, True])
def test_abap_and_block_plan_match(rng, monkeypatch, native, permute_rows):
    _set_native(monkeypatch, native)
    jm = overlapping_block_diagonal_matrix(64, 224, rng, permute_rows=permute_rows)
    tm = _port(jm)
    jp, jh = janalysis.as_banded_as_possible(jm)
    tp, th = tanalysis.as_banded_as_possible(tm)
    assert th == jh
    np.testing.assert_array_equal(tp.indices, jp.indices)
    jplan = janalysis.block_banded_info(jm.permute_rows(jp), 2)
    tplan_ = tanalysis.block_banded_info(tm.permute_rows(tp), 2)
    assert [b.astuple() for b in tplan_.blocks] == [b.astuple() for b in jplan.blocks]
    assert tplan_.nnz_q_estimate == jplan.nnz_q_estimate
    assert tplan_.overlaps() == jplan.overlaps()
    assert tplan_.solved_rows() == jplan.solved_rows()


@pytest.mark.parametrize("native", [True, False])
def test_row_ranges_col_nnz_and_density_match(rng, monkeypatch, native):
    _set_native(monkeypatch, native)
    jm = overlapping_block_diagonal_matrix(40, 140, rng, permute_rows=True)
    tm = _port(jm)
    for got, want in zip(tm.row_ranges(), jm.row_ranges()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tm.col_nnz(), jm.col_nnz())
    np.testing.assert_array_equal(
        tanalysis.column_density(tm).indices, janalysis.column_density(jm).indices
    )


@pytest.mark.parametrize("native", [True, False])
def test_permute_rows_and_blocks_dense_match(rng, monkeypatch, native):
    _set_native(monkeypatch, native)
    jm = overlapping_block_diagonal_matrix(40, 140, rng, permute_rows=False)
    tm = _port(jm)
    perm = rng.permutation(jm.nrows)
    np.testing.assert_array_equal(
        tm.permute_rows(tsparse.Permutation(perm)).to_dense(),
        jm.permute_rows(jsparse.Permutation(perm)).to_dense(),
    )
    blocks = [(0, 0, 9, 4), (7, 2, 9, 4), (120, 34, 14, 6)]
    np.testing.assert_array_equal(tm.blocks_dense(blocks, 14, 6), jm.blocks_dense(blocks, 14, 6))


def test_from_block_diagonal_pattern_plan_matches():
    jplan = janalysis.from_block_diagonal_pattern(77, 22, 7, 2)
    tplan_ = tanalysis.from_block_diagonal_pattern(77, 22, 7, 2)
    assert [b.astuple() for b in tplan_.blocks] == [b.astuple() for b in jplan.blocks]
    assert tplan_.nnz_q_estimate == jplan.nnz_q_estimate
    assert tplan_.is_uniform() and tplan_.num_blocks == 11
    assert tplan_.max_block_rows == 7 and tplan_.max_block_cols == 2
    for got, want in zip(tplan_.as_arrays(), jplan.as_arrays()):
        np.testing.assert_array_equal(got, want)
    assert isinstance(tplan_, tplan.StructurePlan)


def test_permutation_conventions_match(rng):
    """Eigen conventions: P*v scatters rows, A*P gathers columns."""
    idx = rng.permutation(9)
    other = rng.permutation(9)
    P, JP = tsparse.Permutation(idx), jsparse.Permutation(idx)
    v = rng.normal(size=(9, 3))
    np.testing.assert_array_equal(P.apply(v), JP.apply(v))
    np.testing.assert_array_equal(P.apply_inverse(v), JP.apply_inverse(v))
    np.testing.assert_array_equal(P.permute_cols(v.T), JP.permute_cols(v.T))
    np.testing.assert_array_equal(P.inverse().indices, JP.inverse().indices)
    np.testing.assert_array_equal(P.gather_indices(), JP.gather_indices())
    np.testing.assert_array_equal(
        P.then(tsparse.Permutation(other)).indices, JP.then(jsparse.Permutation(other)).indices
    )
    np.testing.assert_array_equal(P.inverse().apply(P.apply(v)), v)
    assert tsparse.Permutation.identity(4).is_identity() and not P.is_identity()


def test_triplets_dense_scipy_roundtrip_match(rng):
    rows = rng.integers(0, 12, size=60)
    cols = rng.integers(0, 9, size=60)  # duplicates are summed
    vals = rng.normal(size=60)
    tm = tsparse.SparseCSR.from_triplets(rows, cols, vals, (12, 9))
    jm = jsparse.SparseCSR.from_triplets(rows, cols, vals, (12, 9))
    np.testing.assert_array_equal(tm.indptr, jm.indptr)
    np.testing.assert_array_equal(tm.indices, jm.indices)
    np.testing.assert_array_equal(tm.data, jm.data)
    assert (tm.nnz, tm.nrows, tm.ncols) == (jm.nnz, jm.nrows, jm.ncols)
    dense = jm.to_dense()
    np.testing.assert_array_equal(tm.to_dense(), dense)
    np.testing.assert_array_equal(tsparse.SparseCSR.from_dense(dense).to_dense(), dense)
    s = sp.csr_matrix(dense)
    np.testing.assert_array_equal(tsparse.SparseCSR.from_scipy(s).to_dense(), dense)
    x = rng.normal(size=9)
    np.testing.assert_allclose(tm.matvec(x), dense @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("permute_rows", [False, True])
def test_block_diagonal_from_sparse_matrix_matches(rng, permute_rows):
    jm = block_diagonal_matrix(20, 70, rng, permute_rows=permute_rows)
    jblk, jperm = JBlockDiagonal.from_sparse_matrix(jm, 2)
    tblk, tperm = BlockDiagonal.from_sparse_matrix(_port(jm), 2, device=DEV)
    np.testing.assert_array_equal(tperm.indices, jperm.indices)
    np.testing.assert_array_equal(tblk.blocks.numpy(), np.asarray(jblk.blocks))
    np.testing.assert_array_equal(tblk.to_dense(), jblk.to_dense())
    assert tblk.shape == jblk.shape


def test_block_diagonal_from_pattern_matches(rng):
    jm = block_diagonal_matrix(16, 56, rng, permute_rows=False)
    jblk = JBlockDiagonal.from_block_diagonal_pattern(jm, 7, 2)
    tblk = BlockDiagonal.from_block_diagonal_pattern(_port(jm), 7, 2, device=DEV)
    np.testing.assert_array_equal(tblk.blocks.numpy(), np.asarray(jblk.blocks))
    assert (tblk.num_blocks, tblk.block_rows, tblk.block_cols) == (8, 7, 2)


# --- banded family: sparse helpers, static pattern, geometry, segmented plan ---


def _tall(nb, br, bc, ov, seed=31):
    from generators import tall_banded_matrix

    return tall_banded_matrix(nb, np.random.default_rng(seed), br=br, bc=bc, ov=ov)


def test_banded_sparse_maps_and_fingerprint_match(rng):
    jm = overlapping_block_diagonal_matrix(40, 140, rng, permute_rows=True)
    tm = _port(jm)
    perm = rng.permutation(jm.nrows)
    np.testing.assert_array_equal(
        tm.row_perm_data_map(tsparse.Permutation(perm)),
        jm.row_perm_data_map(jsparse.Permutation(perm)),
    )
    blocks = [(i * 7, i * 2, 7, 4 if i < 19 else 2) for i in range(20)] + [(0, 0, 0, 0)]
    got, want = tm.panels_gather_map(blocks, 7, 4), jm.panels_gather_map(blocks, 7, 4)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    same = tsparse.SparseCSR(tm.shape, tm.indptr.copy(), tm.indices.copy(), tm.data * 2)
    assert same.pattern_fingerprint() == tm.pattern_fingerprint()
    pruned = tsparse.SparseCSR.from_triplets(
        np.repeat(np.arange(tm.nrows), np.diff(tm.indptr))[1:], tm.indices[1:], tm.data[1:], tm.shape
    )
    assert pruned.pattern_fingerprint() != tm.pattern_fingerprint()


@pytest.mark.parametrize(
    "shape", [(84, 24, 21, 10, 4), (90, 24, 21, 10, 4), (84, 28, 21, 10, 4), (50, 24, 21, 10, 4)],
    ids=["tiles", "zero_tail_rows", "cols_not_tiled", "too_few_rows"],
)
def test_from_block_banded_pattern_matches(shape):
    try:
        want = janalysis.from_block_banded_pattern(*shape)
    except ValueError:
        with pytest.raises(ValueError, match="does not tile"):
            tanalysis.from_block_banded_pattern(*shape)
        return
    got = tanalysis.from_block_banded_pattern(*shape)
    assert [b.astuple() for b in got.blocks] == [b.astuple() for b in want.blocks]
    assert got.nnz_q_estimate == want.nnz_q_estimate


def test_banded_geometry_matches(rng):
    from qrkit_tpu.solvers.banded_blocked import banded_geometry as j_geometry

    from qrkit_tpu_torch.solvers.banded_blocked import banded_geometry as t_geometry

    for jm in (overlapping_block_diagonal_matrix(64, 224, rng, permute_rows=False), _tall(30, 9, 4, 2)):
        plan = janalysis.block_banded_info(jm, 2)
        tplan_ = tanalysis.block_banded_info(_port(jm), 2)
        got, want = t_geometry(tplan_), j_geometry(plan)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


SEGMENTED_PLANS = {  # name -> (nb, br, bc, ov, segment_blocks, suggested_block_cols)
    "tall_64x10x4": (64, 10, 4, 2, 8, 4),
    "config3_block_160": (160, 40, 8, 4, 32, 8),
    "grouped_96x10x4": (96, 10, 4, 2, 4, 4),
}


@pytest.mark.parametrize("name", list(SEGMENTED_PLANS))
def test_segmented_plan_matches(name):
    """The port's host plan (geometry, gates, the W-apply maps, the boundary
    chain's gather map) equals the reference's."""
    from qrkit_tpu.solvers import SegmentedBandedQR as JSegmented

    from qrkit_tpu_torch.solvers import SegmentedBandedQR

    nb, br, bc, ov, L, sug = SEGMENTED_PLANS[name]
    jm = _tall(nb, br, bc, ov)
    jq = JSegmented(suggested_block_cols=sug, segment_blocks=L, use_pallas=True)
    jq.analyze_pattern(jm)
    tq = SegmentedBandedQR(suggested_block_cols=sug, segment_blocks=L, device=DEV)
    tq.analyze_pattern(_port(jm))
    for attr in ("S", "_overlap", "_kw", "_chain_kw", "_chain_group", "_seg_rows", "_seg_row0",
                 "_seg_ncols", "_m1", "_m2", "_nbot", "_nbot2", "_rbot", "_nloc_max",
                 "_max_seg_rows", "_p2_nuni", "_p2_gen_static", "_block_list"):
        assert getattr(tq, attr) == getattr(jq, attr), attr
    for attr in ("_active", "_emit", "_seg_col0", "_bcols_idx", "_icols_idx"):
        np.testing.assert_array_equal(getattr(tq, attr), getattr(jq, attr))
    for k in jq._loc_geom:
        np.testing.assert_array_equal(tq._loc_geom[k], jq._loc_geom[k])
    for k in jq._chain_geom:
        np.testing.assert_array_equal(tq._chain_geom[k], jq._chain_geom[k])
    assert tq._p2_static == jq._p2_static[:3]
    assert (tq._kernel_gate, tq._kernel_ci) == (jq._pallas_gate, jq._pallas_ci)
    np.testing.assert_array_equal(tq.cols_permutation().indices, jq._cols_perm.indices)
    # the W-apply maps; the reference's column group kg is a TPU artefact
    assert (tq._p2w is None) == (jq._p2w is None)
    if jq._p2w is not None:
        st = dict(jq._p2w["statics"])
        assert st.pop("kg") >= 1 and tq._p2w["statics"] == st
        for k in ("feed", "src", "ab"):
            np.testing.assert_array_equal(tq._p2w[k].numpy(), np.asarray(jq._p2w[k]))
        assert tq._p2w["excl"].tolist() == sorted(jq._p2w["excl_static"])
    # the boundary chain: the reference's kernel map is the same map in
    # X-layout, padded to whole nsub groups
    jc = jq._chain_pallas
    assert (tq._chain_kernel is None) == (jc is None)
    if jc is not None:
        nbc = jc["nb"]
        np.testing.assert_array_equal(tq._chain_map.numpy(), np.asarray(jc["map"])[:nbc].transpose(0, 2, 1))
        s = jc["statics"]
        assert tq._chain_kernel == dict(mca=s["mca"], me=s["me"], ci=s["ci"], ci0=s["ci0"])
        assert (s["ma"], s["mc"]) == (tq._chain_kw["max_active"], tq._chain_kw["max_cols"])
    # the solve's index maps (the reference builds them lazily)
    jq._gather_maps()
    jq._ensure_col_gather()
    for port_attr, ref in (
        ("_rbot_gather", jq._rbot_gather), ("_rest_pos", jq._rest_pos), ("_x2_idx", jq._x2_idx),
        ("_bot_starts", jq._bot_starts), ("_row_order", jq._row_order),
        ("_row_order_inv", jq._row_order_inv), ("_seg_gather", jq._seg_gather),
    ):
        np.testing.assert_array_equal(getattr(tq, port_attr).numpy(), np.asarray(ref), port_attr)
    valid = np.asarray(jq._col_valid)
    np.testing.assert_array_equal(tq._col_gather.numpy()[valid], np.asarray(jq._col_gather)[valid])
    assert (tq._col_gather.numpy()[~valid] == tq._m1).all()


def test_config3_full_size_plan():
    """BASELINE.json config 3 at full size (99,960 × 10,000, 2,499 blocks of
    40×8 overlapping 4): the segmented plan, the W-apply statics, the
    boundary chain and the plain chain's kernel geometry."""
    from qrkit_tpu_torch.solvers import BandedBlockedQR, SegmentedBandedQR

    m = _port(_tall(2499, 40, 8, 4))
    assert (m.shape, m.nnz) == ((99960, 10000), 799680)
    seg = SegmentedBandedQR(suggested_block_cols=8, segment_blocks=32, device=DEV).analyze_pattern(m)
    assert seg._delegate is None and (seg.S, seg.L) == (79, 32)
    assert seg._kw == dict(max_active=48, max_cols=8, max_carry=8, max_emit=8)
    assert seg._kernel_gate and seg._kernel_ci == (4, 0)
    assert seg._p2w["statics"] == dict(ma=48, mc=8, mca=8, ko=8, h=124, wrows=164, padr=1344)
    assert seg._p2w["excl"].tolist() == [0]
    assert seg._chain_group == 7 and len(seg._chain_geom["ncols"]) == 12
    assert seg._chain_kw == dict(max_active=88, max_cols=32, max_carry=32, max_emit=28)
    assert seg._chain_kernel == dict(mca=32, me=28, ci=28, ci0=24)
    assert (seg._max_seg_rows, seg._nloc_max, seg._rbot_max, seg._m1, seg._m2) == (1280, 128, 1156, 9688, 312)
    plain = BandedBlockedQR(suggested_block_cols=8, device=DEV).analyze_pattern(m)
    assert plain.plan.num_blocks == 2499 and plain._mR == 40
    assert (plain._max_active, plain._max_cols) == (48, 8)
    assert plain._chain_kernel == dict(mca=8, me=8, ci=4, ci0=4)
