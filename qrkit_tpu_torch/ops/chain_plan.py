"""Chunk plans of the banded chain scans K1 and K2 (host NumPy, once per
pattern).

K1 (the two-segment compact-WY Q / Qᵀ apply,
:func:`~qrkit_tpu_torch.ops.compact_wy.two_segment_apply`) and K2 (the
blocked back-substitution, :func:`~qrkit_tpu_torch.ops.banded.banded_solve_chunk`)
are serial chains of steps, each a linear (K2: affine) map of a few rows of
the operand.  A :class:`ChainPlan` cuts a chain's steps, in serial order
(forward for Qᵀ, reverse for Q and for K2), into chunks of consecutive
steps and the chunks into levels, so that the kernels run a level's chunks
side by side and join them by a short serial pass over their boundaries
(a linear-recurrence form of the SPIKE scheme for banded systems):

1. P1: each chunk of a level runs its steps from the level-start operand
   with its interface rows zeroed, plus one unit column per interface row,
   and keeps its interface-out rows: ``c_J`` (operand columns) and ``M_J``
   (unit columns);
2. P2: one pass over the level's boundaries, ``in_{J+1} = M_J in_J + c_J``;
3. P3: each chunk reruns its steps from the level-start operand and its
   true ``in_J`` and writes the rows it is the writer of.

Definitions, from the host geometry alone (never from factor values):

* **Footprint of a step.**  K1 reads and writes panel rows ``s1 + p`` for
  ``p < split`` (head) and ``s2 + p - split`` otherwise (tail; the tail
  rows ``s2 + r``, ``r >= A - split``, are written back unchanged and are
  no part of it).  K2 reads its window ``[c0 + er, c0 + nc)`` and writes
  ``[c0, c0 + er)`` when the step is active.  Rows in the operand's
  padding count as any other.
* **Hazards** between chunks, taken in serial order: read-after-write,
  write-after-read and write-after-write.
* **Levels.**  A chunk's level is at least its predecessor's and one more
  than that of any non-adjacent chunk it has a hazard with, so every
  hazard sits inside a chunk, between neighbours of one level, or across
  levels.
* **Interface** of chunk J: the rows it reads before writing them whose
  last writer is chunk J−1 of its level.  Wider than ``cap`` (K1: h1, K2:
  max_cols, at most ``MAX_WIDTH``), J merges into J−1 (which then runs
  serially in one CTA), or starts a level when J−1 has merged already: a
  merged chunk that is also its successor's long-distance source would
  swallow the chain.
* **Writer**: the serially last chunk of a level that writes a row; only it
  writes the row back.

A chunk works on a private copy of the rows it touches (its *layout*,
sorted; a step's two segments stay contiguous in it), so its steps run the
serial kernel's arithmetic on local row indices.  A level whose chunks'
row gathers could race with a neighbour's write-back (a row one chunk reads
from the level-start operand and the next writes) gathers in a launch of
its own (``Level.split``).

Chunk length: ``CHUNK_STEPS`` steps (K1 16, K2 32), a constant of the
scan; a chain of fewer than ``MIN_CHUNKS`` chunks' worth of steps keeps one
chunk (no plan: the one-launch kernel).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "CHUNK_STEPS", "ChainPlan", "Level", "MIN_CHUNKS", "check_plan", "chunk_buffers",
    "chunked_plain", "launch_levels", "solve_plan", "two_segment_plan",
]

# steps a chunk, by scan (chip_smoke.py's chain_chunk_sweep on config 3's
# plain chain, PERF.md §6: on the H100 K1 is fastest at 16, K2 flat from 16
# to 32 on one column and fastest at 32 on 16)
CHUNK_STEPS = {"two_seg": 16, "solve": 32}
MIN_CHUNKS = 4
MAX_WIDTH = 64  # the widest interface the boundary pass takes (csrc/chain_apply.cu)

# columns of ChainPlan.chunks: sequence, first serial position, steps,
# offset of its layout in ChainPlan.rows, layout rows, layout offset within
# its level, sum of layout rows × interface width within its level (P1's
# work buffer), interface width in (from the chunk before) and out (to the
# chunk after)
SEQ, START, LEN, ROW0, NROWS, LROW0, LWROW0, WIN, WOUT = range(9)
# columns of ChainPlan.rows: operand row, interface index (or -1), writer
ROW, IFACE, WRITER = range(3)


class Level(NamedTuple):
    """Chunks ``[begin, end)`` of a plan that run side by side."""

    begin: int
    end: int
    iface: bool  # some boundary carries rows: P1 and P2 run
    split: bool  # P3's row gathers run in a launch before its steps
    rows: int  # layout rows of its chunks
    wrows: int  # sum of layout rows × interface width in
    width: int  # its widest interface


class ChainPlan:
    """A chain scan's chunks and levels (module docstring), as host arrays
    and, uploaded once, int64 tensors on the operand's device
    (:attr:`tensors`: ``chunks [n_chunks, 9]``, ``rows [Σ layout, 3]``,
    ``iface_out [n_chunks, wmax]`` (a chunk's local rows of the next
    chunk's interface), ``steps``: K1 ``[2, B, n]`` local ``s1`` / ``s2``,
    K2 ``[B, L]`` local ``c0``)."""

    def __init__(self, kind, transpose, chunk_steps, nsteps, chunks, rows, iface_out, steps,
                 levels, device):
        self.kind, self.transpose = kind, transpose  # K1's direction (None: K2)
        self.chunk_steps, self.nsteps = chunk_steps, nsteps
        self.chunks, self.rows, self.iface_out, self.steps = chunks, rows, iface_out, steps
        self.levels = tuple(levels)
        self.wmax = iface_out.shape[1]
        self.level_chunks = max(lv.end - lv.begin for lv in self.levels)
        self.tensors = {
            name: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64, device=device)
            for name, a in (("chunks", chunks), ("rows", rows), ("iface_out", iface_out),
                            ("steps", steps))
        }

    @property
    def n_chunks(self) -> int:
        return self.chunks.shape[0]

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def scratch_elems(self, k: int) -> int:
        """Elements of the work buffer a call on k columns needs: the
        largest level's layouts at k columns (P3) or k + interface columns
        (P1)."""
        return max(k * lv.rows + (lv.wrows if lv.iface else 0) for lv in self.levels)

    def summary(self) -> dict:
        return {"steps": self.nsteps, "chunk_steps": self.chunk_steps, "chunks": self.n_chunks,
                "levels": self.n_levels,
                "level_chunks": [lv.end - lv.begin for lv in self.levels],
                "width": int(self.chunks[:, WIN].max()), "layout_rows": int(self.rows.shape[0])}


# the chunk kernels' phases (csrc/chain_apply.cu ChunkMode)
FIRST_PASS, GATHER, FINISH, FINISH_ALL = 1, 2, 3, 4


def launch_levels(plan: ChainPlan, phase, join) -> None:
    """Every level's launches in stream order: ``phase(level, mode)`` one
    phase of the chunk kernel over the level's chunks, ``join(level)`` its
    boundary pass (P2)."""
    for lv in plan.levels:
        if lv.iface:
            phase(lv, FIRST_PASS)
            join(lv)
        if lv.split:
            phase(lv, GATHER)
            phase(lv, FINISH)
        else:
            phase(lv, FINISH_ALL)


def check_plan(plan: ChainPlan, kind: str, steps, device, transpose=None) -> None:
    """Raise unless ``plan`` is a plan of ``kind`` (and K1's direction)
    for ``steps`` on ``device``."""
    if (not isinstance(plan, ChainPlan) or plan.kind != kind or plan.transpose != transpose
            or tuple(plan.steps.shape) != steps):
        raise ValueError(f"plan must be a {kind} ChainPlan of steps {steps}"
                         + ("" if transpose is None else f", transpose={transpose}"))
    if any(t.device != device for t in plan.tensors.values()):
        raise ValueError(f"the plan's tensors must be on {device}")


def chunk_buffers(plan: ChainPlan, op: torch.Tensor):
    """The chunked form's scratch for ``op [B, rows, k]``: the work buffer
    of a level's layouts, the interface values ``in`` and the interface-out
    rows ``out`` of a level's chunks."""
    k, w, nch = op.shape[2], plan.wmax, plan.level_chunks
    return (op.new_empty(plan.scratch_elems(k)), op.new_empty(nch * w * k),
            op.new_empty(nch * w * (k + w)))


def _expand(starts, lens, pos):
    """Rows ``starts[i] + [0, lens[i])`` flattened, with ``pos[i]`` beside
    each."""
    lens = np.maximum(lens, 0)
    total = int(lens.sum())
    base = np.repeat(starts - (np.cumsum(lens) - lens), lens)
    return base + np.arange(total), np.repeat(pos, lens)


class _Access:
    """A sequence's step footprints in serial order: reads, writes and
    layout rows as flat arrays grouped by serial position."""

    def __init__(self, n, reads, writes, layout):
        self.n = n
        self.parts = []
        for ranges in (reads, writes, layout):
            rows, pos = zip(*(_expand(s, ln, np.arange(n)) for s, ln in ranges))
            rows, pos = np.concatenate(rows), np.concatenate(pos)
            order = np.argsort(pos, kind="stable")
            off = np.searchsorted(pos[order], np.arange(n + 1))
            self.parts.append((rows[order], pos[order], off))

    def span(self, which, i0, i1):
        rows, pos, off = self.parts[which]
        return rows[off[i0]:off[i1]], pos[off[i0]:off[i1]]


def _first_reads(access, i0, i1):
    """Rows serial steps ``[i0, i1)`` read before writing them (a step reads
    before it writes)."""
    r, rp = access.span(0, i0, i1)
    w, wp = access.span(1, i0, i1)
    rows = np.concatenate([r, w])
    key = np.concatenate([2 * rp, 2 * wp + 1])
    order = np.lexsort((key, rows))
    rows, key = rows[order], key[order]
    first = np.ones(rows.size, dtype=bool)
    first[1:] = rows[1:] != rows[:-1]
    return rows[first & (key % 2 == 0)]


def _mark(last, before, rows, cid):
    new = rows[last[rows] != cid]
    before[new] = last[new]
    last[new] = cid


def _partition(access, chunk, space, cap):
    """Chunks of one sequence: ``[start, len, level, unmerged]`` rows and,
    per chunk, its reads, writes, first reads and interface rows
    (global)."""
    lw = np.full(space, -1, dtype=np.int64)
    lw2, lr, lr2 = lw.copy(), lw.copy(), lw.copy()
    out, sets = [], []
    for i0 in range(0, access.n, chunk):
        i1 = min(i0 + chunk, access.n)
        R = np.unique(access.span(0, i0, i1)[0])
        W = np.unique(access.span(1, i0, i1)[0])
        ext = _first_reads(access, i0, i1)
        level, iface = 0, ext[:0]
        if out:
            p = len(out) - 1
            level = out[p][2]
            TX = np.union1d(R, W)
            cand = np.concatenate([np.where(lw[TX] == p, lw2[TX], lw[TX]),
                                   np.where(lr[W] == p, lr2[W], lr[W])])
            for c in np.unique(cand[cand >= 0]):
                level = max(level, out[c][2] + 1)
            if level == out[p][2]:
                iface = ext[lw[ext] == p]
                if iface.size > cap:
                    if out[p][3]:  # merge into the chunk before, once
                        Rp, Wp, extp, ifp = sets[p]
                        touched = np.union1d(Rp, Wp)
                        sets[p] = (np.union1d(Rp, R), np.union1d(Wp, W),
                                   np.union1d(extp, np.setdiff1d(ext, touched)), ifp)
                        out[p][1] = i1 - out[p][0]
                        out[p][3] = False
                        _mark(lw, lw2, W, p)
                        _mark(lr, lr2, R, p)
                        continue
                    level, iface = level + 1, ext[:0]
        cid = len(out)
        out.append([i0, i1 - i0, level, True])
        sets.append((R, W, ext, iface))
        _mark(lw, lw2, W, cid)
        _mark(lr, lr2, R, cid)
    return out, sets


def _build(kind, transpose, access, steps_of, local_steps, B, chunk, space, cap, device, default):
    """The plan of B sequences (``access[b]``), or None when ``default`` and
    every sequence keeps one chunk.  ``steps_of(b, i0, i1)``: the step
    indices of serial positions ``[i0, i1)``; ``local_steps(b, steps,
    layout)``: their local indices in a chunk's layout."""
    parts = [_partition(access[b], chunk, space, cap) for b in range(B)]
    if default and all(len(p[0]) == 1 for p in parts):
        return None
    nlev = 1 + max(c[2] for p in parts for c in p[0])
    n = access[0].n
    steps = np.zeros((2, B, n) if kind == "two_seg" else (B, n), dtype=np.int64)
    chunks, rows, iface_out, levels, row0 = [], [], [], [], 0
    for lv in range(nlev):
        begin, lrow, lwrow, split = len(chunks), 0, 0, False
        for b, (cs, sets) in enumerate(parts):
            idx = [j for j, c in enumerate(cs) if c[2] == lv]
            written = np.zeros(0, dtype=np.int64)
            writer = {}
            for j in reversed(idx):  # the serially last writer of each row
                W = sets[j][1]
                writer[j] = np.setdiff1d(W, written)
                written = np.union1d(written, W)
            for t, j in enumerate(idx):
                i0, ln = cs[j][:2]
                R, W, ext, iface = sets[j]
                layout = np.unique(access[b].span(2, i0, i0 + ln)[0])
                q = np.full(layout.size, -1, dtype=np.int64)
                q[np.searchsorted(layout, iface)] = np.arange(iface.size)
                wr = np.isin(layout, writer[j]).astype(np.int64)
                if t + 1 < len(idx):
                    nxt_if = sets[idx[t + 1]][3]
                    reads = np.setdiff1d(ext, iface)
                    split |= bool(np.intersect1d(reads, writer[idx[t + 1]]).size)
                else:
                    nxt_if = iface[:0]
                iface_out.append(np.searchsorted(layout, nxt_if))
                st = steps_of(b, i0, i0 + ln)
                if kind == "two_seg":
                    steps[:, b, st] = local_steps(b, st, layout)
                else:
                    steps[b, st] = local_steps(b, st, layout)
                chunks.append([b, i0, ln, row0, layout.size, lrow, lwrow, iface.size,
                               nxt_if.size])
                rows.append(np.stack([layout, q, wr], axis=1))
                row0 += layout.size
                lrow += layout.size
                lwrow += layout.size * iface.size
        levels.append(Level(begin, len(chunks), False, split, lrow, lwrow, 0))
    chunks = np.asarray(chunks, dtype=np.int64)
    wmax = max(int(chunks[:, WIN].max()), 1)
    out = np.zeros((len(iface_out), wmax), dtype=np.int64)
    for c, a in enumerate(iface_out):
        out[c, : a.size] = a
    levels = [lv._replace(iface=bool(chunks[lv.begin:lv.end, WIN].any()),
                          width=int(chunks[lv.begin:lv.end, WIN].max())) for lv in levels]
    return ChainPlan(kind, transpose, chunk, n, chunks, np.concatenate(rows), out, steps, levels,
                     device)


def _rows2d(a):
    a = np.asarray(a, dtype=np.int64)
    return a[None] if a.ndim == 1 else a


def two_segment_plan(s1, s2, split, *, h1: int, A: int, m: int, transpose: bool, device,
                     chunk_steps: Optional[int] = None) -> Optional[ChainPlan]:
    """K1's plan for the Qᵀ (``transpose``) or Q scan of sequences with step
    geometry ``s1``, ``s2``, ``split`` (``[n]`` or ``[B, n]``, host) on an
    operand of ``m`` rows (``m + h1 + A`` with its padding).  None: one
    chunk (fewer than ``MIN_CHUNKS`` chunks' worth of steps, or no cut).
    ``chunk_steps`` forces a length and a plan (tests)."""
    s1, s2, split = (_rows2d(a) for a in (s1, s2, split))
    B, n = s1.shape
    default = chunk_steps is None
    chunk = chunk_steps or CHUNK_STEPS["two_seg"]
    if default and n < MIN_CHUNKS * chunk:
        return None
    sp = np.clip(split, 0, min(h1, A))
    order = np.arange(n) if transpose else np.arange(n - 1, -1, -1)
    access = []
    for b in range(B):
        a1, a2, p = s1[b, order], s2[b, order], sp[b, order]
        foot = ((a1, p), (a2, A - p))
        access.append(_Access(n, foot, foot, ((a1, p), (a2, np.full(n, A)))))

    def local(b, st, layout):
        return np.stack([np.searchsorted(layout, s1[b, st]), np.searchsorted(layout, s2[b, st])])

    return _build("two_seg", bool(transpose), access, lambda b, i0, i1: order[i0:i1], local, B,
                  chunk, m + h1 + A, min(h1, MAX_WIDTH), device, default)


def solve_plan(cols, emit_rows, ncols, active, *, max_emit: int, max_cols: int, rows: int,
               device, chunk_steps: Optional[int] = None) -> Optional[ChainPlan]:
    """K2's plan for back-substitutions with step geometry ``cols``,
    ``emit_rows``, ``ncols``, ``active`` (``[L]`` or ``[B, L]``, host) on
    ``xpad`` of ``rows`` rows; last block first.  None and ``chunk_steps``
    as for :func:`two_segment_plan`."""
    cols, er, nc = (_rows2d(a) for a in (cols, emit_rows, ncols))
    act = np.asarray(active, dtype=bool).reshape(cols.shape)
    B, L = cols.shape
    default = chunk_steps is None
    chunk = chunk_steps or CHUNK_STEPS["solve"]
    if default and L < MIN_CHUNKS * chunk:
        return None
    order = np.arange(L - 1, -1, -1)
    access = []
    for b in range(B):
        c0, e, w = cols[b, order], er[b, order], nc[b, order]
        lo, hi = np.maximum(e, 0), np.clip(w, 0, max_cols)
        live = np.clip(e, 0, max_emit)
        access.append(_Access(L, ((c0 + lo, hi - lo),), ((c0, np.where(act[b, order], live, 0)),),
                              ((c0, np.maximum(hi, live)),)))

    def local(b, st, layout):
        return np.searchsorted(layout, cols[b, st])

    return _build("solve", None, access, lambda b, i0, i1: order[i0:i1], local, B,
                  chunk, rows, min(max_cols, MAX_WIDTH), device, default)


def chunked_plain(plan: ChainPlan, op: torch.Tensor, steps, pad: int) -> None:
    """A torch model of the chunked kernels' three phases on ``plan``,
    updating ``op [B, rows, k]`` in place: ``steps(c, local, ky)`` runs
    chunk c's steps on ``local [1, layout rows + pad, kk]`` (columns past
    ``ky`` are P1's unit columns).  A level's chunks run one after another,
    last first, each gathering its rows just before its steps and writing
    them back just after, unless the level gathers in a launch of its own:
    a race the plan failed to rule out then shows as a wrong result."""
    k = op.shape[2]
    ch, rows = plan.chunks, plan.rows

    def ix(a):
        return torch.as_tensor(a, device=op.device)

    def layout(c):
        return rows[ch[c, ROW0]: ch[c, ROW0] + ch[c, NROWS]]

    def gather(c, extra):
        info = layout(c)
        local = op.new_zeros((1, info.shape[0] + pad, k + extra))
        local[0, : info.shape[0], :k] = op[ch[c, SEQ], ix(info[:, ROW])]
        return local, info

    for lv in plan.levels:
        cs = range(lv.begin, lv.end)
        ins = {}
        if lv.iface:  # P1, then P2
            outs = {}
            for c in cs:
                if not ch[c, WOUT]:
                    continue
                local, info = gather(c, int(ch[c, WIN]))
                at = np.nonzero(info[:, IFACE] >= 0)[0]
                local[0, ix(at), :k] = 0
                local[0, ix(at), ix(k + info[at, IFACE])] = 1
                steps(c, local, k)
                outs[c] = local[0, ix(plan.iface_out[c, : ch[c, WOUT]])]
            for c in cs[:-1]:
                if ch[c, WOUT]:
                    o, w = outs[c], int(ch[c, WIN])
                    ins[c + 1] = o[:, :k] + o[:, k: k + w] @ ins[c] if w else o[:, :k]

        def start(c):
            local, info = gather(c, 0)
            at = np.nonzero(info[:, IFACE] >= 0)[0]
            if at.size:
                local[0, ix(at)] = ins[c][ix(info[at, IFACE])]
            return local, info

        started = {c: start(c) for c in cs} if lv.split else {}
        for c in reversed(cs):  # P3
            local, info = started[c] if lv.split else start(c)
            steps(c, local, k)
            at = np.nonzero(info[:, WRITER])[0]
            op[ch[c, SEQ], ix(info[at, ROW])] = local[0, ix(at)]
