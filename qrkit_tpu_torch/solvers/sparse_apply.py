"""Sparse-operand implicit-Q products for the banded family, on torch tensors.

Counterpart of ``qrkit_tpu/solvers/sparse_apply.py``: the reference's sparse
QProduct (``matrixQ().transpose() * SparseMatrix`` and friends), used by
the block-angular composition's solveRightBlock.  The product is split into

* a **pattern plan** (host, once per operand layout): a conservative-exact
  *structural fill* of ``Qᵀ·S`` from the factorization's touch geometry, plus
  maps that scatter the operand's value vector into dense column chunks of
  ``w`` columns and gather the planned fill positions back out; and
* a **value program** (device, every call): the chunks stacked into one
  dense operand (as many chunks as fit under ``byte_cap``; more groups only
  past it), one Q or Qᵀ apply of the solver, one gather of the fill
  positions, returning flat value vectors for caller-selected index sets.

The reference maps its chunks with ``lax.map`` to bound TPU memory; on the
card a chunk loop would repeat the solver's whole apply per chunk (a
banded chain's apply is a loop over its steps), so the chunks share one
apply under the cap.  The structural fill functions and ``_pad_group`` are
the reference's, verbatim (pure NumPy), so the planned ``(rows, cols)``
equal the reference's exactly.  The structural fill is a superset of the
numeric nonzeros; entries that cancel are stored as explicit zeros
(setFromTriplets without prune), and :func:`solver_sparse_apply` prunes
exact zeros as the reference does.

On the card each same-layout call of :func:`solver_sparse_apply` is one
captured program (:mod:`~qrkit_tpu_torch._program`): one upload of the
operand's values into the program's input, one replay of the value program
and one fetch of the planned values, keyed by the layout and the factor
state, as the reference runs it as one jitted program.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.householder import highest_precision

__all__ = [
    "banded_structural_fill",
    "segmented_structural_fill",
    "build_fused_sparse_apply",
    "solver_sparse_apply",
]

BYTE_CAP = 1 << 30  # dense stacked operand of one apply, bytes


def _op_triplets(op, row_map=None):
    """(rows, cols) of the operand's stored entries, optionally row-mapped
    (``dest = row_map[src]`` — folds a solver row permutation into the plan
    so per-compute host work stays O(1))."""
    rows = np.repeat(np.arange(op.nrows), np.diff(op.indptr))
    if row_map is not None:
        rows = np.asarray(row_map)[rows]
    return rows, np.asarray(op.indices)


def banded_structural_fill(geom, nb: int, m: int, op, transpose: bool,
                           row_map=None):
    """Structural fill of ``Qᵀ·S`` (``transpose=True``) or ``Q·S`` for a plain
    banded chain (:func:`~qrkit_tpu.solvers.banded_blocked.banded_geometry`).

    Exact per-block trigger propagation, vectorized over operand columns;
    the only conservatism is treating the union of triggered touch sets as
    one contiguous interval when testing later intersections (a superset).
    Returns ``(rows, cols)`` sorted column-major (cols, then rows).
    """
    c = np.asarray(geom["cols"][:nb])
    split = np.asarray(geom["carry_rows"][:nb])
    r = np.asarray(geom["rows"][:nb])
    nr = np.asarray(geom["nrows"][:nb])
    op_r, op_c = _op_triplets(op, row_map)
    m2 = op.ncols

    # nz-hit tables: does column j have an original nonzero inside block i's
    # touch set?  T2 row ranges are pairwise disjoint (banded plans overlap in
    # columns, never rows) -> one searchsorted; T1 ranges overlap by at most
    # max(split), scanned by offset.
    nzhit = np.zeros((nb, m2), dtype=bool)
    if op_r.size:
        pos = np.searchsorted(r, op_r, side="right") - 1
        ok = (pos >= 0) & (op_r < r[np.clip(pos, 0, None)] + nr[np.clip(pos, 0, None)])
        nzhit[pos[ok], op_c[ok]] = True
        max_split = int(split.max()) if nb else 0
        for d in range(max_split):
            pos1 = np.searchsorted(c, op_r - d, side="left")
            # all blocks with c == op_r - d (c may repeat); scan the run
            run = pos1.copy()
            while True:
                ok1 = (run < nb) & (c[np.clip(run, 0, nb - 1)] == op_r - d) & (
                    split[np.clip(run, 0, nb - 1)] > d
                )
                if not ok1.any():
                    break
                nzhit[run[ok1], op_c[ok1]] = True
                run = run + 1

    trig = np.zeros((nb, m2), dtype=bool)
    tmin = np.where(split > 0, np.minimum(c, r), r)
    tmax = np.maximum(c + split, r + nr)
    if transpose:  # forward application order
        hi = np.full(m2, -1, dtype=np.int64)
        started = np.zeros(m2, dtype=bool)
        for i in range(nb):
            t = nzhit[i] | (started & (tmin[i] < hi))
            trig[i] = t
            np.maximum(hi, tmax[i], out=hi, where=t)
            started |= t
    else:  # Q: reverse application order, fill propagates to lower blocks
        lo = np.full(m2, m + 1, dtype=np.int64)
        started = np.zeros(m2, dtype=bool)
        for i in range(nb - 1, -1, -1):
            t = nzhit[i] | (started & (tmax[i] > lo))
            trig[i] = t
            np.minimum(lo, tmin[i], out=lo, where=t)
            started |= t

    ti, tj = np.nonzero(trig)
    parts_r = [op_r]
    parts_c = [op_c]
    for base, cnt in ((c, split), (r, nr)):
        cn = cnt[ti]
        tot = int(cn.sum())
        if tot:
            starts = np.concatenate([[0], np.cumsum(cn[:-1])])
            off = np.arange(tot) - np.repeat(starts, cn)
            parts_r.append(np.repeat(base[ti], cn) + off)
            parts_c.append(np.repeat(tj, cn))
    rows = np.concatenate(parts_r)
    cols = np.concatenate(parts_c)
    keys = np.unique(cols.astype(np.int64) * m + rows)
    return keys % m, keys // m


def segmented_structural_fill(solver, op, transpose: bool, row_map=None):
    """Structural fill of ``Qᵀ·S`` / ``Q·S`` for a
    :class:`~qrkit_tpu.solvers.segmented_banded.SegmentedBandedQR`.

    Segment-granular (conservative): cross-segment mixing happens ONLY
    through the compressed boundary chain, so a column triggers whole
    segments plus a suffix (Qᵀ) or prefix (Q) of the chain coordinates.
    Output coordinates follow the solver's apply ordering: Qᵀ returns
    [per-segment R rows | chain rows | pass-through rows]; Q returns natural
    rows.  Returns ``(rows, cols)`` sorted column-major.
    """
    S, o = solver.S, solver._overlap
    m1, nbot2 = solver._m1, solver._nbot2
    m = solver._nrows
    seg_row0 = np.asarray(solver._seg_row0, dtype=np.int64)
    seg_rows = np.asarray(solver._seg_rows, dtype=np.int64)
    seg_ncols = np.asarray(solver._seg_ncols, dtype=np.int64)
    seg_col0 = np.asarray(solver._seg_col0, dtype=np.int64)  # cum interior cols
    rbot = np.asarray(solver._rbot, dtype=np.int64)
    cum_rest = np.concatenate([[0], np.cumsum(rbot - 2 * o)])
    G = solver._chain_group
    chain_c = np.asarray(solver._chain_geom["cols"], dtype=np.int64)
    op_r, op_c = _op_triplets(op, row_map)
    m2 = op.ncols

    gs = np.zeros((S, m2), dtype=bool)  # triggered segments
    chain_lim = np.full(m2, -1, dtype=np.int64)  # per-column chain step extent
    if transpose:
        if op_r.size:
            s_of = np.clip(
                np.searchsorted(seg_row0, op_r, side="right") - 1, 0, S - 1
            )
            gs[s_of, op_c] = True
            # chain fill: suffix from the group of the first triggered segment
            first = np.full(m2, S, dtype=np.int64)
            np.minimum.at(first, op_c, s_of)
            chain_lim = first  # min triggered segment (S = none)
    else:
        if op_r.size:
            top = op_r < m1
            s_top = np.clip(
                np.searchsorted(seg_col0, op_r, side="right") - 1, 0, S - 1
            )
            gs[s_top[top], op_c[top]] = True
            ch = (op_r >= m1) & (op_r < m1 + nbot2)
            step = (op_r - m1) // (2 * o)
            # last chain group whose touch-min <= max nz chain position
            pmax = np.full(m2, -1, dtype=np.int64)
            np.maximum.at(pmax, op_c[ch], op_r[ch] - m1)
            chain_lim = pmax  # max nz chain position (-1 = none)
            rest = op_r >= m1 + nbot2
            s_rest = np.clip(
                np.searchsorted(cum_rest, op_r - m1 - nbot2, side="right") - 1,
                0, S - 1,
            )
            gs[s_rest[rest], op_c[rest]] = True

    rows_l, cols_l = [op_r], [op_c]
    if transpose:
        # chain suffix per column: groups >= chain_lim//G fill [cols, nbot2)
        has = chain_lim < S
        start = np.where(
            has, chain_c[np.clip(chain_lim // G, 0, len(chain_c) - 1)], nbot2
        )
        cnt = nbot2 - start
        tot = int(cnt.sum())
        if tot:
            st = np.concatenate([[0], np.cumsum(cnt[:-1])])
            off = np.arange(tot) - np.repeat(st, cnt)
            rows_l.append(m1 + np.repeat(start, cnt) + off)
            cols_l.append(np.repeat(np.arange(m2), cnt))
        # triggered segments: top R block + pass-through rows
        si, sj = np.nonzero(gs)
        for base, cnt_s in (
            (seg_col0, seg_ncols),
            (m1 + nbot2 + cum_rest[:-1], rbot - 2 * o),
        ):
            cn = cnt_s[si]
            tot = int(cn.sum())
            if tot:
                st = np.concatenate([[0], np.cumsum(cn[:-1])])
                off = np.arange(tot) - np.repeat(st, cn)
                rows_l.append(np.repeat(base[si], cn) + off)
                cols_l.append(np.repeat(sj, cn))
    else:
        # chain prefix -> segments in groups whose touch-min <= pmax trigger
        ngrp = len(chain_c)
        for j in np.nonzero(chain_lim >= 0)[0]:
            gmax = int(np.searchsorted(chain_c, chain_lim[j], side="right")) - 1
            gs[: min((gmax + 1) * G, S), j] = True
        # output (natural rows): whole spans of triggered segments
        si, sj = np.nonzero(gs)
        cn = seg_rows[si]
        tot = int(cn.sum())
        if tot:
            st = np.concatenate([[0], np.cumsum(cn[:-1])])
            off = np.arange(tot) - np.repeat(st, cn)
            rows_l.append(np.repeat(seg_row0[si], cn) + off)
            cols_l.append(np.repeat(sj, cn))
        # input positions of untriggered segments pass through in OUTPUT
        # coordinates different from input ones only via triggered segments,
        # so the original (op_r, op_c) seed rows are dropped — any nz input
        # position belongs to some segment, which is then triggered
        rows_l, cols_l = rows_l[1:], cols_l[1:]
        if not rows_l:
            rows_l, cols_l = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    keys = np.unique(cols.astype(np.int64) * m + rows)
    return keys % m, keys // m


def _pad_group(order, group_of, T, F, payloads, sentinels):
    """Scatter ``payloads[order]`` into ``[T, F]`` arrays grouped by
    ``group_of[order]`` (already group-sorted), padding with sentinels."""
    cnt = np.bincount(group_of, minlength=T)
    starts = np.concatenate([[0], np.cumsum(cnt[:-1])])
    slot = np.arange(group_of.size) - np.repeat(starts, cnt)
    outs = []
    for p, s in zip(payloads, sentinels):
        a = np.full((T, F), s, dtype=np.int64)
        a[group_of, slot] = p[order] if order is not None else p
        outs.append(a)
    return outs


def build_fused_sparse_apply(
    apply_fn, fill_rows, fill_cols, op, m: int, row_map=None, w: int = 128, device=None,
):
    """Build the per-layout plan and its value program.

    ``apply_fn(factors, meta, M)`` is the solver's ``[m, k] → [m, k]`` Q or
    Qᵀ matrix product.  Returns a dict with ``run(factors, meta, data, maps,
    sels)`` → a tuple of flat value vectors (one per entry of ``sels``,
    indices into the flat ``[T, Fout]`` chunk output), the index ``maps``
    (on ``device``, where the values will be), the fill coordinates,
    ``flat_pos`` (each fill entry's flat position) and the chunk geometry.
    Device memory per apply is at most ``BYTE_CAP`` of stacked operand (at
    least one chunk, ``m·w`` elements); no dense ``[m, m2]`` copy of the
    result is kept past the gather.
    """
    m2 = op.ncols
    w = max(1, min(w, m2 if m2 else 1))
    T = max(1, -(-m2 // w))

    # input scatter maps (operand values -> dense [m, w] chunks)
    op_r, op_c = _op_triplets(op, row_map)
    chunk_in = op_c // w
    Fin = max(1, int(np.bincount(chunk_in, minlength=T).max()) if op_r.size else 1)
    order_in = np.argsort(chunk_in, kind="stable")
    in_idx, in_rows, in_lcols = _pad_group(
        order_in, chunk_in[order_in], T, Fin,
        (np.arange(op_r.size), op_r, op_c % w),
        (op.nnz, m, 0),  # sentinel row m: written to a row that is cut off
    )

    # output gather maps (fill positions out of each chunk); fill entry i
    # lands at flat position chunk*Fout + slot
    chunk_out = fill_cols // w
    Fout = max(1, int(np.bincount(chunk_out, minlength=T).max()) if fill_rows.size else 1)
    order_out = np.argsort(chunk_out, kind="stable")
    out_rows, out_lcols = _pad_group(
        order_out, chunk_out[order_out], T, Fout, (fill_rows, fill_cols % w), (0, 0),
    )
    cnt = np.bincount(chunk_out, minlength=T)
    starts = np.concatenate([[0], np.cumsum(cnt[:-1])])
    slot = np.arange(fill_rows.size) - np.repeat(starts, cnt)
    flat_pos = np.empty(fill_rows.size, dtype=np.int64)
    flat_pos[order_out] = chunk_out[order_out] * Fout + slot

    # chunk t's local column l is column t*w + l of the stacked operand
    tw = np.arange(T)[:, None] * w
    maps = {
        k: torch.as_tensor(v, device=device)
        for k, v in dict(in_idx=in_idx, in_rows=in_rows, in_cols=tw + in_lcols,
                         out_rows=out_rows, out_cols=tw + out_lcols).items()
    }

    @highest_precision()
    def run(factors, meta, data, mp, sels):
        pad = torch.cat([data, data.new_zeros(1)])
        per_chunk = (m + 1) * w * data.element_size()
        group = max(1, min(T, BYTE_CAP // per_chunk))
        outs = []
        for t0 in range(0, T, group):
            t1 = min(T, t0 + group)
            M = data.new_zeros((m + 1, (t1 - t0) * w))
            M[mp["in_rows"][t0:t1], mp["in_cols"][t0:t1] - t0 * w] = pad[mp["in_idx"][t0:t1]]
            J = apply_fn(factors, meta, M[:m])
            outs.append(J[mp["out_rows"][t0:t1], mp["out_cols"][t0:t1] - t0 * w])
        flat = torch.cat(outs).reshape(-1)
        return tuple(flat[s] for s in sels)

    return dict(run=run, maps=maps, flat_pos=flat_pos, fill_rows=fill_rows,
                fill_cols=fill_cols, w=w, T=T)


def _value_program(solver, vals, ent):
    """The planned values of one product: the plan's value program over
    the solver's factors (a captured program's function)."""
    factors, meta = solver._sparse_apply_state()
    return ent["plan"]["run"](factors, meta, vals, ent["plan"]["maps"], (ent["sel"],))[0]


def solver_sparse_apply(solver, op, transpose: bool):
    """The banded family's ``apply_qt_sparse`` / ``apply_q_sparse``: the
    reference's ``matrixQ().transpose() * SparseMatrix``.  Plan-cached per
    (direction, operand layout); every call is one upload of the operand's
    values, one value program (one replay on the card, keyed by the layout and
    the solver's factor state) and one fetch.  Exact zeros of the result are
    pruned, as the reference's setFromTriplets does, so nnz matches the
    dense product on generic data.  The values take the factors' dtype."""
    from ..sparse import SparseCSR

    cache = getattr(solver, "_sparse_apply_cache", None)
    if cache is None:
        cache = solver._sparse_apply_cache = {}
    name = f"{type(solver).__name__}.{'apply_qt_sparse' if transpose else 'apply_q_sparse'}"
    key = (transpose, op.pattern_fingerprint(), op.shape)
    ent = cache.get(transpose)
    if ent is None or ent["key"] != key:
        fill_fn, apply_fn = solver._sparse_apply_parts(transpose)
        fr, fc = fill_fn(op, None)
        plan = build_fused_sparse_apply(apply_fn, fr, fc, op, solver.rows, device=solver.device)
        order = np.lexsort((fc, fr))  # CSR (row-major) output order
        ent = dict(key=key, plan=plan,
                   sel=torch.as_tensor(plan["flat_pos"][order], device=solver.device),
                   rows=fr[order], cols=fc[order])
        solver._programs.drop(name)  # their maps go with the old plan
        cache[transpose] = ent
    v = solver._programs.solve(
        solver, name, key, functools.partial(_value_program, ent=ent),
        np.asarray(op.data), upload=(solver.device, solver.dtype), fetch=True,
        mesh=getattr(solver, "_program_mesh", lambda: None)(), axis=getattr(solver, "axis", "dp"),
    )
    nz = v != 0.0
    # the planned entries are distinct and in CSR order already: the CSR
    # is their row counts, with no sort (what from_triplets would build)
    rows = ent["rows"][nz]
    indptr = np.zeros(solver.rows + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(rows, minlength=solver.rows))
    return SparseCSR((solver.rows, op.ncols), indptr, ent["cols"][nz], v[nz])
