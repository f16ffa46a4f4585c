"""Block-diagonal QR on torch tensors: batched dense QR, or the CUDA kernels.

Counterpart of ``qrkit_tpu/solvers/block_diagonal.py`` (``QFormat``,
``BlockDiagonalQR``).  Two tiers share the protocol:

* the batched-torch tier: per-block compact-WY QR (optionally column
  pivoted) over the ``[nb, br, bc]`` batch, explicit ``Q [nb, br, br]`` and
  ``R [nb, k, bc]``;
* the kernel tier (``_kernel_compute`` / ``_kernel_solve_vec``, the
  reference's ``_pallas_compute`` / ``_pallas_solve_vec``): ``compute`` runs
  the packed-R kernel on the SoA operand and keeps the operand resident as
  the implicit Q; a vector ``solve`` is one fused QR + solve kernel launch.
  Dense Q/R materialize lazily, only for the surfaces that need them.

Q formats:
* ``FULL_Q``:           Q columns ordered [all economy blocks | all
                        complements]; R is globally upper-triangular.
* ``BLOCK_DIAGONAL_Q``: Q is block-diagonal; R upper-triangular only up to a
                        row permutation.

With ``mesh=`` (a ``torch.distributed`` ``DeviceMesh``) the block axis is the
distribution axis, as in the reference: every rank calls with the same
global matrix, factors its contiguous chunk of ``nb / world`` blocks (either
tier, so the kernels run per rank) and keeps only those factors.  Every
public result is the global value on every rank: the per-block outputs are
all-gathered, the health flag and the rank all-reduced, and a pivoting
factorization gathers its per-block pivots once, at ``compute``.  Every
method of a sharded solver is therefore collective (call it on every rank).
Sparse R follows the Q format's row layout, as dense R does; the reference
places it by the FULL_Q layout under both formats.

``compute`` on a card operand (either tier) and the kernel tier's vector
``solve`` are each one captured program (:mod:`~qrkit_tpu_torch._program`;
the reference's jitted ``_pallas_compute``, ``_pallas_solve_vec`` and
``_factorize_blocks``): B2 launches inside the compute's graph, B1 inside
the solve's, and over a mesh the health all-reduce, the pivot gather and
the x gather are inside them too.  The factors are the compute program's
outputs.  Without a mesh the compute reads the container's blocks in
place (the kernel tier its SoA, cached by the container for AoS storage),
so a compute is captured for one container and a new container runs
eagerly until it is computed twice in a row; over a mesh the rank's slice
is copied into the program (its address would differ between ranks).
"""
from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from .._program import Programs
from ..containers import BlockDiagonal
from ..functional import block_diagonal_factorize
from ..ops.blockdiag import block_diagonal_lstsq_soa, block_diagonal_qr_r_soa, to_aos
from ..ops.householder import (
    highest_precision,
    rank_from_diag,
    rank_masked_triangular_solve,
)
from ..parallel.mesh import all_gather_leading, all_reduce_sum, shard_bounds
from ..sparse import Permutation, SparseCSR
from .base import QRSolver, _diag_health

__all__ = ["QFormat", "BlockDiagonalQR"]


class QFormat(enum.Enum):
    FULL_Q = 0
    BLOCK_DIAGONAL_Q = 1


def _diag_rows(bc: int):
    """Rows of the packed (j, c >= j) R holding the diagonal."""
    return [j * bc - j * (j - 1) // 2 for j in range(bc)]


def _packed_diag(r_soa: torch.Tensor, bc: int) -> torch.Tensor:
    """Per-block diagonals ``[nb, bc]`` of the packed R."""
    # stack row views rather than index with a host list: list indexing
    # copies the index to the device from pageable memory, a host sync
    return torch.stack([r_soa[i] for i in _diag_rows(bc)], dim=1)


def _columns_first(yb: torch.Tensor) -> torch.Tensor:
    """Per-block rhs ``[blocks, r]`` as they are, or ``[blocks, r, k]`` as
    ``[k, blocks, r]``: a batch of the vector's solves, one a column."""
    return yb.movedim(-1, 0) if yb.dim() == 3 else yb


def _pad_to(v: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-extend a vector (or a matrix's rows) to length n (zero tail
    columns), or cut it."""
    if v.shape[0] < n:
        v = torch.cat([v, v.new_zeros((n - v.shape[0],) + v.shape[1:])])
    return v[:n]


@highest_precision()
def _kernel_compute(a_soa: torch.Tensor, *, br: int, ncols: int):
    """Kernel-tier factorize: packed R from the CUDA kernel (plain version on
    a CPU tensor) and the health flag from its diagonal, all on the device.
    Returns ``(r_soa [ntri, nb], health)``."""
    bc = a_soa.shape[0] // br
    r_soa = block_diagonal_qr_r_soa(a_soa, br)
    d = _pad_to(_packed_diag(r_soa, bc).reshape(-1), ncols)
    return r_soa, _diag_health(d, check_zero=True)


def _compute_program(self, a_in):
    """The factorize of :meth:`BlockDiagonalQR.compute` on this rank's
    blocks (``a_in`` SoA ``[br*bc, nb]`` in the kernel tier, else AoS
    ``[nb, br, bc]``; over a mesh the rank's slice of the operand).  Kernel
    tier: ``(a_soa, r_soa, health)``, ``a_soa`` the resident operand the
    solves read (``a_in`` made contiguous: over a mesh, the program's
    static input); batched tier: ``(Q, R, perm, health)`` (``perm`` None
    without pivoting, the pivots of every block over a mesh).  The health
    flag is every rank's (one all-reduce over a mesh)."""
    if self._kernel_mode:
        a_soa = a_in.contiguous()
        r_soa, health = _kernel_compute(a_soa, br=self._br, ncols=self._ncols_own)
        return a_soa, r_soa, self._all_healthy(health)
    Q, R, local_perm = block_diagonal_factorize(a_in, pivot=self.pivot)
    d = torch.diagonal(R, dim1=1, dim2=2).reshape(-1)
    health = _diag_health(
        d if self._landscape else _pad_to(d, self._ncols_own),
        check_zero=self._health_check_zero_pivot,
    )
    perm = self._gather(local_perm) if self.pivot else None
    return Q, R, perm, self._all_healthy(health)


def _solve_program(self, b):
    """The kernel tier's vector solve: B1 on this rank's rows, the x chunks
    gathered over the mesh, zero tail columns → x [ncols]."""
    br = self._br
    x = _kernel_solve_vec(self._a_soa, b[self._b0 * br : self._b1 * br], br=br)
    return _pad_to(self._gather(x.reshape(-1, self._bc)).reshape(-1), self._ncols)


@highest_precision()
def _kernel_solve_vec(a_soa: torch.Tensor, b: torch.Tensor, *, br: int) -> torch.Tensor:
    """Kernel-tier least-squares solve against the resident SoA operand:
    relayout b, one fused QR + solve launch, relayout x.  ``b`` holds the
    blocks' nb*br rows; returns x [nb*bc]."""
    b_soa = b.reshape(-1, br).T.contiguous()
    return block_diagonal_lstsq_soa(a_soa, b_soa).T.reshape(-1)


class BlockDiagonalQR(QRSolver):
    """QR of a :class:`~qrkit_tpu_torch.containers.BlockDiagonal` matrix.

    ``pivot=True`` uses per-block column pivoting (the reference's default
    ``ColPivHouseholderQR`` block solver) and composes the per-block
    permutations into the global column permutation.

    ``use_kernel`` picks the tier: ``"auto"`` runs the CUDA kernels for a
    CUDA operand of a supported geometry (non-pivoting, portrait blocks with
    br*bc <= 64, nrows >= nb*br); ``True`` demands the kernel tier (raising
    if the geometry is unsupported; on a CPU operand that tier runs the
    kernels' plain versions); ``False`` keeps the batched-torch tier.  Both
    float32 and float64 run in the kernel tier.

    ``mesh``/``axis`` shard the block axis over the ranks of a
    ``DeviceMesh`` axis (see the module docstring); ``nb`` must divide over
    them (ValueError otherwise, where the reference's ``device_put``
    refuses).  Each rank's blocks take the tier its gate picks: the
    reference keeps its Pallas tier off under a mesh only because a
    ``pallas_call`` does not partition under XLA's SPMD.
    """

    def __init__(
        self,
        q_format: QFormat = QFormat.FULL_Q,
        pivot: bool = True,
        mesh=None,
        axis: str = "dp",
        use_kernel="auto",
    ):
        if use_kernel not in ("auto", True, False):
            raise ValueError(f"use_kernel must be 'auto', True or False, got {use_kernel!r}")
        self.q_format = q_format
        self.pivot = pivot
        self.mesh = mesh
        self.axis = axis
        self.use_kernel = use_kernel
        self._kernel_mode = False
        self._health_check_zero_pivot = not pivot
        self._computed = False
        self._programs = Programs()
        self._maps = None  # (shape and device, FULL_Q destination rows), see _index_maps

    def _kernel_supported(self, mat: BlockDiagonal) -> bool:
        br, bc = mat.block_rows, mat.block_cols
        return (
            not self.pivot
            and br >= bc
            and br * bc <= 64
            and mat.nrows >= mat.num_blocks * br
        )

    def _kernel_active(self, mat: BlockDiagonal) -> bool:
        if self.use_kernel is False:
            return False
        sup = self._kernel_supported(mat)
        if self.use_kernel is True:
            if not sup:
                raise ValueError(
                    "use_kernel=True but this factorization is not supported by "
                    "the kernel tier (needs pivot=False and portrait blocks with "
                    "br*bc <= 64); use use_kernel='auto'"
                )
            return True
        return sup and mat.device.type == "cuda"

    # --- QRSolver shape -----------------------------------------------------------
    @property
    def rows(self) -> int:
        return self._nrows

    @property
    def cols(self) -> int:
        return self._ncols

    # --- factorization ------------------------------------------------------------
    def compute(
        self, mat: BlockDiagonal, row_perm: Optional[Permutation] = None
    ) -> "BlockDiagonalQR":
        # Landscape (cols > rows) blocks yield a full [br, br] Q and a wide
        # upper-trapezoidal R, so Q is block-diagonal under both formats and
        # the stacked R rows are already globally upper-triangular.
        self._landscape = mat.block_cols > mat.block_rows
        self._nrows, self._ncols = mat.nrows, mat.ncols
        self._nb = mat.num_blocks
        self._br, self._bc = mat.block_rows, mat.block_cols
        self._shard()
        # None stands for the identity, built only if asked for: an explicit
        # identity is O(nrows) host work (56 MB at 1M 7x2 blocks) per compute
        self._row_perm = row_perm
        b0, b1 = self._b0, self._b1
        self._kernel_mode = self._kernel_active(mat)
        # without a mesh the container's SoA (its storage, or the layout it
        # caches) is the kernels' operand as it is, read in place by the
        # program (no copy in); over a mesh the rank's slice is copied into
        # the program's static input (its address differs between ranks,
        # which must all capture at the same call)
        a_in = mat.soa() if self._kernel_mode else mat.blocks
        if self.mesh is not None:
            a_in = a_in[:, b0:b1] if self._kernel_mode else a_in[b0:b1]
        key = (self._kernel_mode, self.pivot, self._landscape, self._ncols_own)
        out = self._programs.factorize(
            self, "BlockDiagonalQR.compute", key, _compute_program, a_in,
            resident=int(self.mesh is None), mesh=self.mesh, axis=self.axis,
        )
        self._computed = True
        if self._kernel_mode:
            self._a_soa, self._r_soa, health = out
            self.Q = self.R = None
            self._local_perm = None
        else:
            # the pivot order stays on the device (gathered over the mesh);
            # cols_permutation() fetches it on first use, and solve() scatters
            # with it on the device
            self.Q, self.R, self._local_perm, health = out
        self._set_success(health)
        return self

    # --- the block shard of a mesh ------------------------------------------------
    def _shard(self) -> None:
        """This rank's blocks [b0, b1) (all of them without a mesh) and the
        columns its share of the diagonal covers (the zero tail columns go
        with the last block)."""
        if self.mesh is None:
            self._b0, self._b1 = 0, self._nb
        else:
            self._b0, self._b1 = shard_bounds(self._nb, self.mesh, self.axis)
        tail = self._ncols - self._nb * self._bc if self._b1 == self._nb else 0
        self._ncols_own = (self._b1 - self._b0) * self._bc + tail

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Per-block values of this rank's blocks ``[b1 - b0, ...]`` → all
        blocks ``[nb, ...]`` (the identity without a mesh)."""
        return t if self.mesh is None else all_gather_leading(t, self.mesh, self.axis)

    def _all_healthy(self, health: torch.Tensor) -> torch.Tensor:
        """This rank's health flag → every rank's, combined on the device."""
        if self.mesh is None:
            return health
        return all_reduce_sum((~health).to(torch.int32), self.mesh, self.axis) == 0

    def _global_factors(self):
        """The explicit per-block ``(Q [nb, br, br], R [nb, k, bc])`` of all
        blocks (gathered over the mesh), for the exports and the sparse-A2
        product of :class:`~qrkit_tpu_torch.solvers.block_angular.BlockAngularQR`."""
        self._ensure_dense_factors()
        return self._gather(self.Q), self._gather(self.R)

    def _adopt_factors(self, mat: BlockDiagonal, Q, R, health) -> None:
        """Take factors computed by an enclosing fused program
        (``BlockAngularQR``'s fused dense path), with the post-conditions of
        :meth:`compute` for the non-pivoting portrait case in the
        batched-torch tier."""
        if self.pivot or self.mesh is not None:
            raise ValueError("_adopt_factors takes non-pivoting factors without a mesh only")
        self._kernel_mode = False
        self._landscape = mat.block_cols > mat.block_rows
        self._nrows, self._ncols = mat.nrows, mat.ncols
        self._nb = mat.num_blocks
        self._br, self._bc = mat.block_rows, mat.block_cols
        self._shard()
        self._row_perm = None
        self.Q, self.R = Q, R
        self._local_perm = None
        self._computed = True
        self._programs.bind_eager()
        self._set_success(health)

    def _ensure_dense_factors(self) -> None:
        """Materialize the explicit per-block Q/R batch from the kernel
        tier's resident SoA operand — only for the surfaces that need a
        dense factor (sparse exports, applies, solve_r, matrix rhs)."""
        if not self._kernel_mode or self.Q is not None:
            return
        blocks = to_aos(self._a_soa, self._br, self._bc)
        self.Q, self.R, _ = block_diagonal_factorize(blocks, pivot=False)

    def _diag_blocks(self) -> torch.Tensor:
        """Per-block pivot diagonals of this rank's blocks ``[b1 - b0, k]``."""
        if self._kernel_mode:
            return _packed_diag(self._r_soa, self._bc)
        return torch.diagonal(self.R, dim1=1, dim2=2)

    def r_diagonal(self) -> torch.Tensor:
        """Pivot diagonal of R straight from the factors — no dense R.
        Portrait: [ncols] (columns past nb*bc report 0).  Landscape: the
        nb*br leading pivots."""
        d = self._gather(self._diag_blocks()).reshape(-1)
        return d if self._landscape else _pad_to(d, self._ncols)

    # --- Q application ------------------------------------------------------------
    def _index_maps(self, device):
        """(econ_rows, comp_rows) destination rows for FULL_Q coordinates;
        complement columns start right after the nb*bc economy columns.
        Made once per shape and device and kept: a captured product reads
        them where they lie (a copy from the host cannot be captured)."""
        nb, br, bc = self._nb, self._br, self._bc
        key = (nb, br, bc, torch.device(device))
        cached = self._maps
        if cached is None or cached[0] != key:
            econ = (np.arange(nb)[:, None] * bc + np.arange(bc)).reshape(-1)
            comp_w = br - bc
            comp = (nb * bc + np.arange(nb)[:, None] * comp_w + np.arange(comp_w)).reshape(-1)
            self._maps = cached = (key, torch.as_tensor(econ, device=device),
                                   torch.as_tensor(comp, device=device))
        return cached[1], cached[2]

    def _block_diagonal_q(self) -> bool:
        return self.q_format == QFormat.BLOCK_DIAGONAL_Q or self._landscape

    @highest_precision()
    def apply_qt(self, m: torch.Tensor) -> torch.Tensor:
        self._ensure_dense_factors()
        vec = m.dim() == 1
        m2 = m[:, None] if vec else m
        k = m2.shape[1]
        nb, br, bc = self._nb, self._br, self._bc
        own = m2[self._b0 * br : self._b1 * br].reshape(-1, br, k)
        outb = self._gather(torch.einsum("bij,bik->bjk", self.Q, own))
        if self._block_diagonal_q():
            out = torch.cat([outb.reshape(nb * br, k), m2[nb * br :]], dim=0)
        else:
            econ, comp = self._index_maps(m2.device)
            out = torch.empty_like(m2)
            out[econ] = outb[:, :bc].reshape(nb * bc, k)
            out[comp] = outb[:, bc:].reshape(nb * (br - bc), k)
            out[nb * br :] = m2[nb * br :]  # zero-tail rows: identity Q
        return out[:, 0] if vec else out

    @highest_precision()
    def apply_q(self, m: torch.Tensor) -> torch.Tensor:
        self._ensure_dense_factors()
        vec = m.dim() == 1
        m2 = m[:, None] if vec else m
        k = m2.shape[1]
        nb, br, bc = self._nb, self._br, self._bc
        if self._block_diagonal_q():
            coords = m2[: nb * br].reshape(nb, br, k)
        else:
            econ, comp = self._index_maps(m2.device)
            coords = torch.cat(
                [m2[econ].reshape(nb, bc, k), m2[comp].reshape(nb, br - bc, k)], dim=1
            )
        outb = self._gather(torch.einsum("bij,bjk->bik", self.Q, coords[self._b0 : self._b1]))
        out = torch.cat([outb.reshape(nb * br, k), m2[nb * br :]], dim=0)
        return out[:, 0] if vec else out

    # --- R --------------------------------------------------------------------------
    def _r_row_stride(self) -> int:
        """Row stride of the per-block R rows in the global R: FULL_Q stacks
        them at i*bc, BLOCK_DIAGONAL_Q (and landscape blocks, under both
        formats, whose stacked rows are already upper-triangular) at i*br."""
        return self._br if self._block_diagonal_q() else self._bc

    def matrix_r_dense(self) -> torch.Tensor:
        _, Rb = self._global_factors()
        nb, br, bc = self._nb, self._br, self._bc
        k = min(br, bc)
        R = Rb.new_zeros((self._nrows, self._ncols))
        i = torch.arange(nb, device=R.device)
        rows = i[:, None] * self._r_row_stride() + torch.arange(k, device=R.device)
        cols = i[:, None] * bc + torch.arange(bc, device=R.device)
        R[rows[:, :, None], cols[:, None, :]] = Rb
        return R

    @highest_precision()
    def solve_r(self, y: torch.Tensor) -> torch.Tensor:
        """R x = y for ``y [n]`` or ``[n, k]``: the per-block triangular
        solves, a matrix's columns as a batch of the vector's (each column
        under its blocks' rank masks when pivoting)."""
        self._ensure_dense_factors()
        if self._landscape:
            return self._solve_r_landscape(y)
        if self.q_format != QFormat.FULL_Q:
            raise ValueError("solve_r requires QFormat.FULL_Q")
        nb, br, bc = self._nb, self._br, self._bc
        yb = _columns_first(y[: nb * bc].reshape((nb, bc) + y.shape[1:])[self._b0 : self._b1])
        if self.pivot:
            # per-block rank-masked basic solution: ColPiv clusters each
            # block's dead pivots at its tail
            ks = rank_from_diag(torch.diagonal(self.R, dim1=1, dim2=2), br, bc)
            xb = rank_masked_triangular_solve(self.R, yb, ks)
        else:
            xb = torch.linalg.solve_triangular(self.R, yb[..., None], upper=True)[..., 0]
        return self._x_from_blocks(xb, y)

    def _solve_r_landscape(self, y: torch.Tensor) -> torch.Tensor:
        """Basic solution of the underdetermined per-block systems: the wide
        [br, bc] trapezoid is embedded in a [bc, bc] triangle whose tail rows
        are identity, so x is supported only on the leading pivot columns."""
        nb, br, bc = self._nb, self._br, self._bc
        yb = _columns_first(y[: nb * br].reshape((nb, br) + y.shape[1:])[self._b0 : self._b1])
        nbl = yb.shape[-2]
        rhs = torch.cat([yb, yb.new_zeros(yb.shape[:-1] + (bc - br,))], dim=-1)
        eye_tail = torch.eye(bc, dtype=self.R.dtype, device=self.R.device)[br:]
        Rsq = torch.cat([self.R, eye_tail.expand(nbl, bc - br, bc)], dim=1)
        if self.pivot:
            ks = rank_from_diag(torch.diagonal(self.R[:, :br], dim1=1, dim2=2), br, bc)
            xb = rank_masked_triangular_solve(Rsq, rhs, ks)
        else:
            xb = torch.linalg.solve_triangular(Rsq, rhs[..., None], upper=True)[..., 0]
        return self._x_from_blocks(xb, y)

    def _x_from_blocks(self, xb: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Per-block solutions (``[k, blocks, bc]`` for a matrix ``y``) →
        x ``[ncols]`` or ``[ncols, k]``, gathered over the mesh."""
        if y.dim() == 2:
            xb = xb.movedim(0, -1)
        nb, bc = self._nb, self._bc
        return _pad_to(self._gather(xb).reshape((nb * bc,) + y.shape[1:]), self._ncols)

    @highest_precision()
    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """Least-squares solve.  In the kernel tier a vector rhs is ONE fused
        QR + solve kernel launch against the resident SoA operand (on each
        rank, for its blocks' rows; the x chunks are then gathered); a matrix
        rhs and the batched-torch tier use the generic path.  The rhs tail
        past nb*br is ignored; x is zero past nb*bc (zero tail columns)."""
        if self._kernel_mode and b.dim() == 1:
            return self._programs.solve(
                self, "BlockDiagonalQR.solve", (), _solve_program, b, mesh=self.mesh,
                axis=self.axis,
            )
        return super().solve(b)

    def _unpermute(self, z: torch.Tensor) -> torch.Tensor:
        """Per-block pivot scatter on the device (no host fetch of the pivots):
        x[i*bc + perm[i, j]] = z[i*bc + j]."""
        if self._local_perm is None:
            return z
        nb, bc = self._nb, self._bc
        head = z[: nb * bc].reshape((nb, bc) + z.shape[1:])
        idx = self._local_perm.reshape((nb, bc) + (1,) * (z.dim() - 1)).expand(head.shape)
        return torch.cat([torch.zeros_like(head).scatter(1, idx, head).reshape(
            (nb * bc,) + z.shape[1:]), z[nb * bc :]])

    def cols_permutation(self) -> Permutation:
        if self._local_perm is None:
            return Permutation.identity(self._ncols)
        lp = self._local_perm.cpu().numpy()
        base = np.arange(self._nb)[:, None] * self._bc
        return Permutation(
            np.concatenate([(base + lp).reshape(-1), np.arange(self._nb * self._bc, self._ncols)])
        )

    def rows_permutation(self) -> Permutation:
        if self._row_perm is None:
            return Permutation.identity(self._nrows)
        return self._row_perm

    def matrix_r_sparse(self) -> SparseCSR:
        """Sparse R in O(nnz(R)): block-diagonal of per-block upper triangles
        at the rows :meth:`matrix_r_dense` puts them (``i*bc`` under FULL_Q,
        ``i*br`` under BLOCK_DIAGONAL_Q and for landscape blocks)."""
        Rb = self._global_factors()[1].detach().cpu().numpy()
        nb, k, bc = Rb.shape
        r, c = np.triu_indices(k, 0, bc)
        row_stride = self._r_row_stride()
        rows = (np.arange(nb)[:, None] * row_stride + r[None, :]).ravel()
        cols = (np.arange(nb)[:, None] * bc + c[None, :]).ravel()
        vals = Rb[:, r, c].ravel()
        keep = vals != 0.0  # the reference prunes exact zeros
        return SparseCSR.from_triplets(
            rows[keep], cols[keep], vals[keep], (self._nrows, self._ncols)
        )

    def matrix_q_sparse(self) -> SparseCSR:
        """Explicit sparse Q in O(nb·br²): FULL_Q orders columns [all economy
        blocks | all complements] (+ identity on zero tail rows);
        BLOCK_DIAGONAL_Q is block-diagonal."""
        nb, br, bc = self._nb, self._br, self._bc
        Qb = self._global_factors()[0].detach().cpu().numpy()
        i = np.arange(nb)[:, None, None]
        r = np.arange(br)[None, :, None]
        c = np.arange(br)[None, None, :]
        rows = np.broadcast_to(i * br + r, (nb, br, br)).reshape(-1)
        if self._block_diagonal_q():
            cols = i * br + c
        else:
            cols = np.where(c < bc, i * bc + c, nb * bc + i * (br - bc) + (c - bc))
        cols = np.broadcast_to(cols, (nb, br, br)).reshape(-1)
        vals = Qb.reshape(-1)
        tail = np.arange(nb * br, self._nrows)
        rows = np.concatenate([rows, tail])
        cols = np.concatenate([cols, tail])
        vals = np.concatenate([vals, np.ones(tail.size, vals.dtype)])
        return SparseCSR.from_triplets(rows, cols, vals, (self._nrows, self._nrows))

    @property
    def rank(self) -> int:
        """Numerical rank = sum of per-block ranks (pivot=True only; without
        pivoting this reports min(rows, cols) like the reference
        HouseholderQR)."""
        if not self.pivot:
            return min(self._ncols, self._nb * self._br)
        d = torch.diagonal(self.R, dim1=1, dim2=2)
        k = rank_from_diag(d, self._br, self._bc).sum()
        if self.mesh is not None:
            k = all_reduce_sum(k, self.mesh, self.axis)
        return int(k.item())
