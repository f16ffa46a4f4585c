// The banded family's two serial scans for Hopper (sm_90a): the two-segment
// compact-WY Q / Q^T apply (K1) and the blocked banded back-substitution
// (K2).
//
// Neither replaces a Pallas kernel: the reference runs both as lax.scan
// bodies, which the port first wrote out as Python loops of small torch ops.
//   two_seg_kernel       <- qrkit_tpu/ops/compact_wy.py _apply_two_seg (:185)
//                           and its lane-major twin _apply_two_seg_cols (:228)
//   banded_solve_kernel  <- qrkit_tpu/solvers/banded_blocked.py
//                           _banded_solve_chunk (:238)
// Their plain versions are ops/compact_wy.py _two_segment_apply_plain and
// ops/banded.py _banded_solve_chunk_plain; the wrappers beside them
// (two_segment_apply, banded_solve_chunk) launch these kernels, and
// _two_segment_apply_chunked_plain / _banded_solve_chunked_plain model the
// chunked forms' phases on a plan.
//
// Layouts (sequence index first, nothing padded):
//   K1: y [B, n, A, C], t [B, n, C, C], s1 / s2 / split [B, n] int64,
//       m [B, mp, k] (the operand with h1 + A zero rows appended by the
//       wrapper, updated in place; row r of column j at r*k + j)
//   K2: ypad, xpad [B, rows, k] (xpad zeroed by the wrapper), r_panels
//       [B, L, E, mc] (the first me rows of each panel are read), cols /
//       emit / ncols [B, L] int64, active [B, L] bool
//
// K1, one step l of sequence b on operand column j (steps forward for Q^T,
// in reverse for Q): panel row p < split gathers row s1 + p, the others row
// s2 + p - split; wg += Y (T' (Y^T wg)) with T' = T^T for Q^T; the head rows
// p < split are written back first, then the tail: rows s2 + r for r < A -
// split get panel row r + split, the rest their values from the step's start.
// So a row that both segments touch ends with the tail's value, as in the
// plain version's two ordered scatters, and a step with Y = T = 0 writes
// every row back unchanged.  Precondition (every solver's geometry):
// 0 <= split <= min(h1, A); the kernel clamps split into that range.
//
// K2, one step l (last block first): with c0, er, nc its start, emitted rows
// and columns, subtract the solved overlap columns [er, nc) of the window
// x[c0 : c0 + mc] from y[c0 : c0 + er], back-substitute the er live rows
// through the upper triangle of the panel's leading er x er block, row by
// row, and write them to x when the step is active.
//
// Bound: latency.  Both scans are serial in their steps, and a step moves
// a few KB (config 3's 48 x 8 fp32 panel: 1.5 KB of Y and 256 B of T; a
// 8 x 8 R panel), so a call moves some MB while the byte bound allows a
// few us.  Run as one scan, config 3's 2,499-step chain on one vector is
// one CTA on one of 132 SMs, one warp walking 2,499 dependent steps of
// 1.0-1.5 us: no faster step reaches the library's dense
// solve_triangular.  So the serial dependency is split (ops/chain_plan.py,
// a linear-recurrence form of the SPIKE scheme): a host plan cuts a long
// chain into chunks (16 steps for K1, 32 for K2) and the chunks into
// levels, such that inside a level a chunk depends only on its neighbour,
// through a few interface rows (config 3: 4).  Per level, three phases,
// each its own launch, so no CTA waits on another:
//   P1  two_seg_chunk_kernel / solve_chunk_kernel, kFirstPass: every chunk
//       at once runs its steps on its k operand columns with its interface
//       rows zeroed, plus one unit column per interface row, and keeps its
//       interface-out rows c_J and their map M_J;
//   P2  chunk_join_kernel: one warp a group of columns walks the level's
//       boundaries, in_{J+1} = M_J in_J + c_J (4 x 4 products on config 3);
//   P3  kGather + kFinish (or kFinishAll): every chunk reruns its steps
//       from the level-start rows and its true in_J and writes back the
//       rows it is the writer of.
// A chunk works on a private layout of the rows it touches, gathered from
// the operand (the steps' indices rewritten into it by the plan), so its
// steps are exactly the one-chunk scan below; a level whose gathers could
// race with a neighbour's write-back gathers in a launch of its own.  A
// call's time is then levels x (2 x chunk steps x the per-step latency) +
// the boundary hops + a few us a launch: config 3's K2 one level, 32 + 32
// steps and 78 hops; K1's Q^T a merged first chunk of 32 steps and two
// levels of 16 + 16, 153 hops.  The chunks' extra work (k + w columns in
// P1, every step twice) costs nothing on the critical path: it runs on
// the 131 SMs the one-chunk form leaves idle, and the operand's
// bytes (config 3: 0.4 MB a column) are read and written a few times a
// level at the card's memory rate.  plan None (short chains: the segmented
// solver's 32-step segments and its boundary chain) keeps one launch of
// two_seg_kernel / banded_solve_kernel.  Within a chunk, the one-chunk
// design:
//
// * One CTA per (sequence, group of operand columns: at most 2 for K1, 7
//   for K2), one warp per column; columns are independent, so B x k warps
//   fill the grid.  A lone warp runs its step as one dependent chain of
//   instructions, so what is not the step's arithmetic stays off it:
// * The step's panel (Y and T for K1, the R panel for K2) is staged in
//   shared memory with an odd row stride (no bank conflicts between lanes
//   on consecutive rows) by the CTA's own staging warp, with cp.async one
//   step ahead, two buffers and one CTA barrier a step; a geometry whose
//   two stages do not fit beside the warps' scratch takes one stage (copy,
//   wait, compute).
//   The wrapper picks warps and stages (ops/compact_wy.py two_segment_launch,
//   ops/banded.py solve_chunk_launch) and the launcher checks
//   the shared memory it implies.
// * A warp's scratch (two sets, by step parity, of the step's gathered
//   rows: the panel rows and the tail rows' start-of-step values for K1,
//   the overlap window of x and y's rows for K2; Y^T wg and T' (Y^T wg), or
//   the right-hand side and the rows solved) lives in shared memory; lane t
//   owns rows t, t+32, ...
// * No step waits on device memory for what its predecessor wrote.  While
//   step i computes, cp.async brings step i+1's rows from device memory,
//   except those step i writes; after its update step i copies those from
//   its own scratch (the value its scatter leaves: K1's tail lands after
//   its head).  The operand and x stay in device memory (config 3: 0.4 MB
//   a column).  K1's staging warp also makes those copies and writes
//   step i-1's rows back (each row once, with the value the ordered
//   scatters leave) while step i computes, from a third scratch set; K2's
//   column warps do both themselves.  What a step reads from device memory
//   was written at least a step before, ordered by the CTA barrier or by
//   __syncwarp, which orders memory among the lanes of a warp.  The steps'
//   start indices are loaded two steps ahead.
// * K1's Y^T wg splits the lanes into 32 / C' groups of C' columns (C'
//   = C rounded up to a power of two, at most 32), each group summing every
//   (32 / C')th row, and adds the groups with one shuffle butterfly.  K2
//   keeps a row a lane (panels of up to 32 emitted rows): the rhs and the
//   reciprocal of R_rr in registers, x_r = rhs_r (1 / R_rr) to every lane
//   by one shuffle a row, the rows above subtract R_ir x_r; wider panels
//   divide, with the rhs in shared memory and one __syncwarp a row.
//
// No atomics and a fixed order of every sum (P2's included, and the plan
// is fixed by the geometry), so a call is deterministic and a replay equals
// its eager call.  A chunked call differs from the one-chunk form only by
// the rounding of the interface values P2 composes.
// Numerics: correctly rounded division and reciprocal, no FMA contraction
// (--fmad=false).  The sums run in other orders than the plain versions'
// matrix products and torch.linalg.solve_triangular, and K2 multiplies by
// 1 / R_rr where the plain version divides, so the results agree to
// rounding.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC   (ops/_build.py, one library for all shapes)

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 7;  // operand-column warps of a CTA, beside its staging warp

struct TwoSegArgs {
  int n, A, C, h1, k, stages, col_groups, transpose;
  int64_t mp;
};

struct SolveArgs {
  int L, E, me, mc, k, stages, col_groups;
  int64_t rows;
};

// Copy a [rows x cols] row-major block into shared memory with row stride
// `stride`, element by element (an element's alignment is all the operands
// guarantee), thread `tid` of `nt`; the caller commits.  (r, c) advance by
// nt without a division.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, int rows, int cols,
                                           int stride, int tid, int nt) {
  const int dr = nt / cols, dc = nt - dr * cols;
  int r = tid / cols, c = tid - r * cols;
  for (int i = tid; i < rows * cols; i += nt) {
    __pipeline_memcpy_async(dst + r * stride + c, src + i, sizeof(T));
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// One step's rows of a K1 scan: panel row p gathers operand row
// head + p (p < sp) or tail + p - sp; tail rows r >= A - sp keep their
// start-of-step values.  Rows are below 2^31 (the launcher checks).
struct TwoSegStep {
  int head, tail, sp;
  __device__ __forceinline__ int panel_row(int p) const { return p < sp ? head + p : tail + p - sp; }
  // whether this step writes operand row r
  __device__ __forceinline__ bool writes(int r, int A) const {
    return (unsigned)(r - tail) < (unsigned)A || (unsigned)(r - head) < (unsigned)sp;
  }
  // the value this step leaves in operand row r (which it writes): the
  // tail's scatter lands last
  template <typename T>
  __device__ __forceinline__ T written(int r, int A, const T* wg, const T* old) const {
    const int j = r - tail;
    if ((unsigned)j < (unsigned)A) return j < A - sp ? wg[j + sp] : old[j];
    return wg[r - head];
  }
};

// Serial steps [i0, i0 + len) of one sequence's K1 scan (serial position
// i is step i for Q^T, n - 1 - i for Q) on the rows at mb (row r of the
// CTA's column w at mb[r * k + w], ncol live columns); yb / tb and the
// index arrays start at the sequence's step 0.  Every thread of the CTA
// calls it; it ends with the last step's rows written back.
template <typename T>
__device__ __forceinline__ void two_seg_scan(const T* __restrict__ yb, const T* __restrict__ tb,
                                             const int64_t* __restrict__ s1,
                                             const int64_t* __restrict__ s2,
                                             const int64_t* __restrict__ split, T* __restrict__ mb,
                                             const int64_t k, const int ncol, const int i0,
                                             const int len, const TwoSegArgs& g, T* sm) {
  const int A = g.A, C = g.C, cs = C | 1;
  const int ye = A * cs, stage = ye + C * cs;
  // warps 0 .. nw-1 own an operand column each; warp nw (the stager) stages
  // the panels, brings every column's rows in and writes them back
  const int nw = (blockDim.x >> 5) - 1, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool stager = warp == nw;
  const int per_warp = 6 * A + 2 * C;
  // column warp w's scratch: three sets (by step, mod 3) of the gathered
  // panel rows and the tail rows' start-of-step values, then Y^T wg, T' u
  auto wg_of = [&](int w, int set) { return sm + g.stages * stage + w * per_warp + set * A; };
  auto old_of = [&](int w, int set) { return sm + g.stages * stage + w * per_warp + (3 + set) * A; };
  T* u = sm + g.stages * stage + warp * per_warp + 6 * A;
  T* z = u + C;

  const bool live = warp < ncol;
  int cp = 1;
  while (cp < C && cp < 32) cp <<= 1;
  const int groups = 32 / cp, grp = lane / cp, cl = lane % cp;
  const int spmax = g.h1 < A ? g.h1 : A;

  auto step_of = [&](int i) { return g.transpose ? i0 + i : g.n - 1 - (i0 + i); };
  auto load_step = [&](int i) {
    const int l = step_of(i);
    const int64_t sp = split[l];
    return TwoSegStep{(int)s1[l], (int)s2[l], (int)(sp < 0 ? 0 : (sp > spmax ? spmax : sp))};
  };
  // the stager's jobs, its lanes over (column, row) pairs
  auto fetch = [&](T* dst, int i) {
    const int l = step_of(i);
    stage_rows(dst, yb + (int64_t)l * A * C, A, C, cs, lane, 32);
    stage_rows(dst + ye, tb + (int64_t)l * C * C, C, C, cs, lane, 32);
  };
  // step nx's rows into set `set`: from device memory, except those the
  // step before it (cur) writes, which the column warps fill in
  auto prefetch = [&](int set, const TwoSegStep& nx, bool have_cur, const TwoSegStep& cur) {
    for (int p = lane; p < A; p += 32) {
      const int r = nx.panel_row(p), ro = nx.tail + p;
      const bool row = !(have_cur && cur.writes(r, A));
      const bool old = p >= A - nx.sp && !(have_cur && cur.writes(ro, A));
      for (int w = 0; w < ncol; ++w) {
        if (row) __pipeline_memcpy_async(wg_of(w, set) + p, mb + (int64_t)r * k + w, sizeof(T));
        if (old) __pipeline_memcpy_async(old_of(w, set) + p, mb + (int64_t)ro * k + w, sizeof(T));
      }
    }
  };
  // step s's rows back to device memory from set `set`, each row once with
  // the value the plain version's ordered scatters leave (the tail's)
  auto store = [&](int set, const TwoSegStep& s) {
    for (int j = lane; j < A; j += 32) {
      const bool head = j < s.sp && (unsigned)(s.head + j - s.tail) >= (unsigned)A;
      for (int w = 0; w < ncol; ++w) {
        const T* wg = wg_of(w, set);
        mb[(int64_t)(s.tail + j) * k + w] = j < A - s.sp ? wg[j + s.sp] : old_of(w, set)[j];
        if (head) mb[(int64_t)(s.head + j) * k + w] = wg[j];
      }
    }
  };

  TwoSegStep prev{0, 0, 0};
  TwoSegStep cur = load_step(0);
  TwoSegStep nxt = len > 1 ? load_step(1) : cur;
  if (stager) {
    prefetch(0, cur, false, cur);
    if (g.stages == 2) fetch(sm, 0);
  }
  __pipeline_commit();
  for (int i = 0; i < len; ++i) {
    const int q = i & 1, set = i % 3, nset = (i + 1) % 3, pset = (i + 2) % 3;
    const T* st;
    if (g.stages == 2) {
      st = sm + q * stage;
      __pipeline_wait_prior(0);
      __syncthreads();  // step i's stage and rows are in; step i-1 is done
    } else {
      st = sm;
      __syncthreads();  // every warp is done with step i-1's stage
      if (stager) fetch(sm, i);
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
    }
    if (stager) {
      if (i > 0) {
        store(pset, prev);
        __syncwarp();  // step i-1's rows land before the prefetch reads
      }
      if (i + 1 < len) {
        if (g.stages == 2) fetch(sm + (q ^ 1) * stage, i + 1);
        prefetch(nset, nxt, true, cur);
      }
    }
    __pipeline_commit();
    const TwoSegStep after = i + 2 < len ? load_step(i + 2) : nxt;  // loads fly during the step
    if (live) {
      T* wg = wg_of(warp, set);
      const T* ts = st + ye;
      for (int c0 = 0; c0 < C; c0 += 32) {
        const int c = c0 + cl;
        T part = T(0);
        if (c < C) {
#pragma unroll 4
          for (int p = grp; p < A; p += groups) part = part + st[p * cs + c] * wg[p];
        }
        for (int off = cp; off < 32; off <<= 1) part = part + __shfl_xor_sync(kFull, part, off);
        if (grp == 0 && c < C) u[c] = part;
      }
      __syncwarp();
      for (int c = lane; c < C; c += 32) {
        T acc = T(0);
        if (g.transpose) {
#pragma unroll 4
          for (int j = 0; j < C; ++j) acc = acc + ts[j * cs + c] * u[j];
        } else {
#pragma unroll 4
          for (int j = 0; j < C; ++j) acc = acc + ts[c * cs + j] * u[j];
        }
        z[c] = acc;
      }
      __syncwarp();
      for (int p = lane; p < A; p += 32) {
        T acc = T(0);
#pragma unroll 4
        for (int c = 0; c < C; ++c) acc = acc + st[p * cs + c] * z[c];
        wg[p] = wg[p] + acc;
      }
      if (i + 1 < len) {
        __syncwarp();  // every lane's wg is final
        // step i+1's rows that step i writes, from this step's set
        T* nwg = wg_of(warp, nset);
        T* nold = old_of(warp, nset);
        const T* old = old_of(warp, set);
        for (int p = lane; p < A; p += 32) {
          const int r = nxt.panel_row(p);
          if (cur.writes(r, A)) nwg[p] = cur.written(r, A, wg, old);
          const int ro = nxt.tail + p;
          if (p >= A - nxt.sp && cur.writes(ro, A)) nold[p] = cur.written(ro, A, wg, old);
        }
      }
    }
    prev = cur;
    cur = nxt;
    nxt = after;
  }
  __syncthreads();  // the last step's rows are final
  if (stager) store((len - 1) % 3, prev);
}

template <typename T>
__global__ void __launch_bounds__(256)
    two_seg_kernel(const T* __restrict__ y, const T* __restrict__ t,
                   const int64_t* __restrict__ s1, const int64_t* __restrict__ s2,
                   const int64_t* __restrict__ split, T* __restrict__ m, TwoSegArgs g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t nw = (blockDim.x >> 5) - 1;
  const int64_t b = blockIdx.x / g.col_groups;
  const int64_t col0 = (int64_t)(blockIdx.x % g.col_groups) * nw;
  const int ncol = (int)(g.k - col0 < nw ? g.k - col0 : nw);  // live column warps
  two_seg_scan(y + b * g.n * (int64_t)g.A * g.C, t + b * g.n * (int64_t)g.C * g.C, s1 + b * g.n,
               s2 + b * g.n, split + b * g.n, m + b * g.mp * g.k + col0, g.k, ncol, 0, g.n, g,
               reinterpret_cast<T*>(smem_raw));
}

// Serial steps [i0, i0 + len) of one chain's K2 scan (serial position i is
// block L - 1 - i): the CTA's column w reads y at y0[r * ky + w] (zero for
// w >= ny) and x at x0[r * kx + w] (ncol live columns); step l reads y at
// rows cols[l] + r and x at rows xcols[l] + c (the same rows, or their
// places in a chunk's layout); rb and the index arrays start at the chain's
// block 0.  Every thread of the CTA calls it.
template <typename T>
__device__ __forceinline__ void solve_scan(const T* __restrict__ y0, const int64_t ky, const int ny,
                                           T* __restrict__ x0, const int64_t kx, const int ncol,
                                           const T* __restrict__ rb,
                                           const int64_t* __restrict__ cols,
                                           const int64_t* __restrict__ xcols,
                                           const int64_t* __restrict__ emit,
                                           const int64_t* __restrict__ ncols,
                                           const uint8_t* __restrict__ active, const int i0,
                                           const int len, const SolveArgs& g, T* sm) {
  const int me = g.me, mc = g.mc, ms = mc | 1;
  const int stage = me * ms;
  const int nw = (blockDim.x >> 5) - 1, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool stager = warp == nw;
  // a column warp's scratch: two sets (by step parity) of the window of x
  // and of y's rows, then the right-hand side and the rows solved
  T* xwb = sm + g.stages * stage + warp * (2 * mc + 4 * me);
  T* yvb = xwb + 2 * mc;
  T* rhs = yvb + 2 * me;
  T* solved = rhs + me;

  const bool live = !stager && warp < ncol, has_y = warp < ny;
  const T* yc = y0 + warp;
  T* xc = x0 + warp;

  struct Step {
    int c0, cy, er, nc;  // x's and y's rows below 2^31 (the launcher checks)
    int lr;          // live rows: er within [0, me]
    bool act;
  };
  auto load_step = [&](int i) {
    const int l = g.L - 1 - (i0 + i);
    const int64_t er = emit[l], nc = ncols[l];
    const int erc = (int)(er < 0 ? -1 : (er > mc ? mc : er));
    return Step{(int)xcols[l], (int)cols[l], erc, (int)(nc < 0 ? -1 : (nc > mc ? mc : nc)),
                (int)(er < 0 ? 0 : (er > me ? me : er)), active[l] != 0};
  };
  auto fetch = [&](T* dst, int i) {
    if (stager) stage_rows(dst, rb + (int64_t)(g.L - 1 - (i0 + i)) * g.E * mc, me, mc, ms, lane, 32);
  };
  // whether step `s` writes x's row r
  auto writes = [&](const Step& s, int r) { return s.act && (unsigned)(r - s.c0) < (unsigned)s.lr; };
  // step nx's overlap window and y rows into set q: from device memory
  // unless the current step writes them (fill() supplies those)
  auto prefetch = [&](int q, const Step& nx, bool have_cur, const Step& cur) {
    if (!live) return;
    for (int c = lane; c < mc; c += 32) {
      const int r = nx.c0 + c;
      if (c >= nx.er && c < nx.nc && !(have_cur && writes(cur, r)))
        __pipeline_memcpy_async(xwb + q * mc + c, xc + (int64_t)r * kx, sizeof(T));
    }
    if (has_y)
      for (int r = lane; r < nx.lr; r += 32)
        __pipeline_memcpy_async(yvb + q * me + r, yc + (int64_t)(nx.cy + r) * ky, sizeof(T));
  };
  auto fill = [&](int q, const Step& nx, const Step& cur) {
    for (int c = lane; c < mc; c += 32) {
      const int r = nx.c0 + c;
      if (c >= nx.er && c < nx.nc && writes(cur, r)) xwb[q * mc + c] = solved[r - cur.c0];
    }
  };

  if (live && !has_y) {  // a unit column of a chunk's first pass: y = 0
    for (int r = lane; r < 2 * me; r += 32) yvb[r] = T(0);
    __syncwarp();
  }
  Step cur = load_step(0);
  Step nxt = len > 1 ? load_step(1) : cur;
  prefetch(0, cur, false, cur);
  if (g.stages == 2) fetch(sm, 0);
  __pipeline_commit();
  for (int i = 0; i < len; ++i) {
    const int q = i & 1;
    const T* v;
    if (g.stages == 2) {
      v = sm + q * stage;
      __pipeline_wait_prior(0);
      __syncthreads();
      if (i + 1 < len) {
        fetch(sm + (q ^ 1) * stage, i + 1);
        prefetch(q ^ 1, nxt, true, cur);
      }
      __pipeline_commit();
    } else {
      v = sm;
      __syncthreads();
      fetch(sm, i);
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      if (i + 1 < len) prefetch(q ^ 1, nxt, true, cur);
      __pipeline_commit();
    }
    const Step after = i + 2 < len ? load_step(i + 2) : nxt;
    if (live) {
      const T* xw = xwb + q * mc;
      const T* yv = yvb + q * me;
      const int lr = cur.lr, lo = cur.er < 0 ? 0 : cur.er;
      // the rhs of the live rows: y less the solved overlap columns [er, nc)
      if (me <= 32) {
        // a row a lane: the rhs and the reciprocal of the diagonal in
        // registers, x_rr from its lane by one shuffle a row
        T r_own = T(0), inv = T(0);
        if (lane < lr) {
          T sub = T(0);
#pragma unroll 4
          for (int c = lo; c < cur.nc; ++c) sub = sub + v[lane * ms + c] * xw[c];
          r_own = yv[lane] - sub;
          inv = T(1) / v[lane * ms + lane];
        }
        T x_own = T(0);
        for (int rr = lr - 1; rr >= 0; --rr) {
          const T x = __shfl_sync(kFull, r_own * inv, rr);
          if (lane == rr) x_own = x;
          if (lane < rr) r_own = r_own - v[lane * ms + rr] * x;
        }
        if (lane < lr) {
          solved[lane] = x_own;
          if (cur.act) xc[(int64_t)(cur.c0 + lane) * kx] = x_own;
        }
      } else {
        for (int r = lane; r < lr; r += 32) {
          T sub = T(0);
#pragma unroll 4
          for (int c = lo; c < cur.nc; ++c) sub = sub + v[r * ms + c] * xw[c];
          rhs[r] = yv[r] - sub;
        }
        __syncwarp();
        for (int rr = lr - 1; rr >= 0; --rr) {
          const T x = rhs[rr] / v[rr * ms + rr];
          if (lane == (rr & 31)) {
            solved[rr] = x;
            if (cur.act) xc[(int64_t)(cur.c0 + rr) * kx] = x;
          }
          for (int r = lane; r < rr; r += 32) rhs[r] = rhs[r] - v[r * ms + rr] * x;
          __syncwarp();
        }
      }
      __syncwarp();  // every solved row is in place
      if (i + 1 < len) fill(q ^ 1, nxt, cur);
      __syncwarp();  // the next step's window is in place
    }
    cur = nxt;
    nxt = after;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    banded_solve_kernel(const T* __restrict__ ypad, const T* __restrict__ rp,
                        const int64_t* __restrict__ cols, const int64_t* __restrict__ emit,
                        const int64_t* __restrict__ ncols, const uint8_t* __restrict__ active,
                        T* __restrict__ xpad, SolveArgs g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t nw = (blockDim.x >> 5) - 1;
  const int64_t b = blockIdx.x / g.col_groups;
  const int64_t col0 = (int64_t)(blockIdx.x % g.col_groups) * nw;
  const int ncol = (int)(g.k - col0 < nw ? g.k - col0 : nw);
  const int64_t off = b * g.rows * g.k + col0;
  const int64_t* c = cols + b * g.L;
  solve_scan(ypad + off, g.k, ncol, xpad + off, g.k, ncol, rp + b * g.L * (int64_t)g.E * g.mc, c, c,
             emit + b * g.L, ncols + b * g.L, active + b * g.L, 0, g.L, g,
             reinterpret_cast<T*>(smem_raw));
}

// --- the chunked forms: one level of a chain plan (ops/chain_plan.py) ---
//
// chunks [n_chunks, 9]: sequence, first serial position, steps, offset of
// its layout in rows, layout rows, layout offset and layout x width offset
// within the level, interface width in and out; rows [*, 3]: operand row,
// interface index (-1: none), writer flag; iface_out [n_chunks, wmax]: a
// chunk's local rows of the next chunk's interface.  A CTA takes one
// (chunk, group of columns) of the level; its layout lives in the work
// buffer scr, row u of column j at work[u * kk + j].  in [level chunks,
// wmax, k]: each chunk's interface values; out [level chunks, wmax, k +
// wmax]: a chunk's interface-out rows, c_J in columns [0, k), M_J after.
enum ChunkCol { kSeq, kStart, kLen, kRow0, kRows, kLRow0, kLWRow0, kWin, kWout, kChunkCols };
enum ChunkMode {
  kFirstPass = 1,  // P1: gather (interface zeroed, unit columns), steps, keep c_J and M_J
  kGather = 2,     // P3's gathers alone (before any chunk of the level writes back)
  kFinish = 3,     // P3's steps and write-back, on the gathered layouts
  kFinishAll = 4,  // P3 whole: gather, steps, write-back
};

struct ChunkArgs {
  int64_t k;   // operand columns
  int64_t mp;  // operand rows per sequence
  int c_begin, col_groups, wmax, mode;
};

struct Chunk {
  int64_t b, i0, len, row0, rows, work, win, wout, kk;
  int lc;  // chunk index within its level
};

// this CTA's chunk and its work buffer's offset and width
__device__ __forceinline__ Chunk chunk_of(const int64_t* __restrict__ chunks, const ChunkArgs& a) {
  const int c = a.c_begin + (int)(blockIdx.x / a.col_groups);
  const int64_t* ch = chunks + (int64_t)c * kChunkCols;
  const bool first = a.mode == kFirstPass;
  const int64_t win = ch[kWin];
  return Chunk{ch[kSeq], ch[kStart], ch[kLen], ch[kRow0], ch[kRows],
               a.k * ch[kLRow0] + (first ? ch[kLWRow0] : 0), win, ch[kWout],
               first ? a.k + win : a.k, c - a.c_begin};
}

// The chunk's rows into its work buffer, columns [col0, col0 + ncol): the
// operand's level-start rows, the interface rows from `in` (P3) or zero
// with one unit column each (P1).
template <typename T>
__device__ __forceinline__ void chunk_gather(const Chunk& ch, const int64_t* __restrict__ info,
                                             const T* __restrict__ opb, const T* __restrict__ in,
                                             T* __restrict__ work, int64_t col0, int ncol,
                                             const ChunkArgs& a) {
  const bool first = a.mode == kFirstPass;
  for (int64_t e = threadIdx.x; e < ch.rows * ncol; e += blockDim.x) {
    const int64_t u = e / ncol, col = col0 + (e - u * ncol);
    const int64_t r = info[3 * u], q = info[3 * u + 1];
    T v;
    if (col >= a.k)
      v = q == col - a.k ? T(1) : T(0);
    else if (q >= 0)
      v = first ? T(0) : in[((int64_t)ch.lc * a.wmax + q) * a.k + col];
    else
      v = opb[r * a.k + col];
    work[u * ch.kk + col] = v;
  }
}

// After the chunk's steps: P1 keeps the next chunk's interface rows, P3
// writes back the rows the chunk is the writer of.
template <typename T>
__device__ __forceinline__ void chunk_finish(const Chunk& ch, const int64_t* __restrict__ info,
                                             const int64_t* __restrict__ iout, T* __restrict__ opb,
                                             T* __restrict__ out, const T* __restrict__ work,
                                             int64_t col0, int ncol, const ChunkArgs& a) {
  if (a.mode == kFirstPass) {
    const int64_t* io = iout + (int64_t)(a.c_begin + ch.lc) * a.wmax;
    for (int e = threadIdx.x; e < ch.wout * ncol; e += blockDim.x) {
      const int q = e / ncol;
      const int64_t col = col0 + (e - q * ncol);
      out[((int64_t)ch.lc * a.wmax + q) * (a.k + a.wmax) + col] = work[io[q] * ch.kk + col];
    }
    return;
  }
  for (int64_t e = threadIdx.x; e < ch.rows * ncol; e += blockDim.x) {
    const int64_t u = e / ncol, col = col0 + (e - u * ncol);
    if (info[3 * u + 2]) opb[info[3 * u] * a.k + col] = work[u * ch.kk + col];
  }
}

// One phase of a level of K1's chunked form (ChunkMode) over the CTAs of
// its (chunk, column group) pairs.
template <typename T>
__global__ void __launch_bounds__(256)
    two_seg_chunk_kernel(const T* __restrict__ y, const T* __restrict__ t,
                         const int64_t* __restrict__ ls1, const int64_t* __restrict__ ls2,
                         const int64_t* __restrict__ split, const int64_t* __restrict__ chunks,
                         const int64_t* __restrict__ rows, const int64_t* __restrict__ iout,
                         T* __restrict__ op, T* __restrict__ scr, const T* __restrict__ in,
                         T* __restrict__ out, TwoSegArgs g, ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Chunk ch = chunk_of(chunks, a);
  const int64_t nw = (blockDim.x >> 5) - 1;
  const int64_t col0 = (int64_t)(blockIdx.x % a.col_groups) * nw;
  if ((a.mode == kFirstPass && ch.wout == 0) || col0 >= ch.kk) return;  // the whole CTA
  const int ncol = (int)(ch.kk - col0 < nw ? ch.kk - col0 : nw);
  const int64_t* info = rows + 3 * ch.row0;
  T* opb = op + ch.b * a.mp * a.k;
  T* work = scr + ch.work;
  if (a.mode != kFinish) chunk_gather(ch, info, opb, in, work, col0, ncol, a);
  if (a.mode == kGather) return;
  __syncthreads();  // the layout is in place
  two_seg_scan(y + ch.b * g.n * (int64_t)g.A * g.C, t + ch.b * g.n * (int64_t)g.C * g.C,
               ls1 + ch.b * g.n, ls2 + ch.b * g.n, split + ch.b * g.n, work + col0, ch.kk, ncol,
               (int)ch.i0, (int)ch.len, g, reinterpret_cast<T*>(smem_raw));
  __syncthreads();  // the last step's rows are back in the layout
  chunk_finish(ch, info, iout, opb, out, work, col0, ncol, a);
}

// The same for K2: y is read in place (zero in P1's unit columns), x's rows
// in the chunk's layout (xcols: each step's c0 there).
template <typename T>
__global__ void __launch_bounds__(256)
    solve_chunk_kernel(const T* __restrict__ ypad, const T* __restrict__ rp,
                       const int64_t* __restrict__ cols, const int64_t* __restrict__ xcols,
                       const int64_t* __restrict__ emit, const int64_t* __restrict__ ncols,
                       const uint8_t* __restrict__ active, const int64_t* __restrict__ chunks,
                       const int64_t* __restrict__ rows, const int64_t* __restrict__ iout,
                       T* __restrict__ xpad, T* __restrict__ scr, const T* __restrict__ in,
                       T* __restrict__ out, SolveArgs g, ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Chunk ch = chunk_of(chunks, a);
  const int64_t nw = (blockDim.x >> 5) - 1;
  const int64_t col0 = (int64_t)(blockIdx.x % a.col_groups) * nw;
  if ((a.mode == kFirstPass && ch.wout == 0) || col0 >= ch.kk) return;
  const int ncol = (int)(ch.kk - col0 < nw ? ch.kk - col0 : nw);
  const int ny = (int)(a.k - col0 < 0 ? 0 : (a.k - col0 < ncol ? a.k - col0 : ncol));
  const int64_t* info = rows + 3 * ch.row0;
  T* xb = xpad + ch.b * a.mp * a.k;
  T* work = scr + ch.work;
  if (a.mode != kFinish) chunk_gather(ch, info, xb, in, work, col0, ncol, a);
  if (a.mode == kGather) return;
  __syncthreads();
  const int64_t o = ch.b * g.L;
  solve_scan(ypad + ch.b * a.mp * a.k + col0, a.k, ny, work + col0, ch.kk, ncol,
             rp + o * g.E * g.mc, cols + o, xcols + o, emit + o, ncols + o, active + o,
             (int)ch.i0, (int)ch.len, g, reinterpret_cast<T*>(smem_raw));
  __syncthreads();
  chunk_finish(ch, info, iout, xb, out, work, col0, ncol, a);
}

// P2, the boundary pass of a level: in_{J+1} = M_J in_J + c_J over its
// chunks in order (the first has no interface).  Columns are independent
// here, so one warp takes kJoinCols of them, alone in its CTA: a boundary
// costs two __syncwarp and w_in products a value, and no CTA barrier.
// Each boundary's widths and its c_J and M_J rows are staged kJoinStages
// boundaries ahead with cp.async; in_J stays in shared memory, so no load
// from device memory waits on the path.
constexpr int kJoinCols = 8, kJoinStages = 4;

struct JoinArgs {
  int64_t k;
  int c_begin, c_end, wmax;
};

template <typename T>
__global__ void __launch_bounds__(32)
    chunk_join_kernel(const int64_t* __restrict__ chunks, const T* __restrict__ out,
                      T* __restrict__ in, JoinArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int64_t* wid = reinterpret_cast<int64_t*>(smem_raw);  // a stage's (w_out, w_in)
  T* sm = reinterpret_cast<T*>(smem_raw + 2 * kJoinStages * sizeof(int64_t));
  const int wm = a.wmax, rs = kJoinCols + wm, stage = wm * rs, lane = threadIdx.x;
  T* cur = sm + kJoinStages * stage;
  T* nxt = cur + wm * kJoinCols;
  const int64_t j0 = (int64_t)blockIdx.x * kJoinCols, ostride = a.k + wm;
  const int kc = (int)(a.k - j0 < kJoinCols ? a.k - j0 : kJoinCols);
  const int hops = a.c_end - a.c_begin - 1;
  // boundary h's widths and rows (all wmax of them: no width on the copy's path)
  auto stage_hop = [&](int h) {
    if (h < hops) {
      const int slot = h % kJoinStages;
      const int64_t* ch = chunks + (int64_t)(a.c_begin + h) * kChunkCols;
      if (lane < 2)
        __pipeline_memcpy_async(wid + 2 * slot + lane, ch + (lane ? kWin : kWout), sizeof(int64_t));
      const T* src = out + (int64_t)h * wm * ostride;
      T* dst = sm + slot * stage;
      int q = lane / rs, r = lane - q * rs;  // (q, r) advance by 32 without a division
      const int dq = 32 / rs, dr = 32 - dq * rs;
      for (int e = lane; e < stage; e += 32) {
        if (r < kc || r >= kJoinCols)
          __pipeline_memcpy_async(dst + e, src + q * ostride + (r < kc ? j0 + r : a.k + r - kJoinCols),
                                  sizeof(T));
        q += dq;
        r += dr;
        if (r >= rs) {
          r -= rs;
          ++q;
        }
      }
    }
    __pipeline_commit();
  };
  for (int h = 0; h < kJoinStages; ++h) stage_hop(h);
  const int jj = lane % kJoinCols, q0 = lane / kJoinCols;
  constexpr int dq = 32 / kJoinCols;
  for (int h = 0; h < hops; ++h) {
    __pipeline_wait_prior(kJoinStages - 1);
    __syncwarp();  // boundary h is in; in_h is in cur
    const int slot = h % kJoinStages;
    const int w = (int)wid[2 * slot], wi = (int)wid[2 * slot + 1];
    const T* st = sm + slot * stage;
    if (jj < kc) {
      for (int q = q0; q < w; q += dq) {
        T acc = st[q * rs + jj];
        for (int p = 0; p < wi; ++p) acc = acc + st[q * rs + kJoinCols + p] * cur[p * kJoinCols + jj];
        nxt[q * kJoinCols + jj] = acc;
        in[((int64_t)(h + 1) * wm + q) * a.k + j0 + jj] = acc;
      }
    }
    __syncwarp();  // every lane is done with the stage and with cur
    stage_hop(h + kJoinStages);
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

// above 48 KB a kernel's dynamic shared memory needs an opt-in
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool launch_shape(int64_t seqs, int64_t k, int64_t warps, int64_t stages, int64_t* groups) {
  if (warps < 1 || warps > kMaxWarps || (stages != 1 && stages != 2) || k < 1) return false;
  *groups = (k + warps - 1) / warps;
  return seqs >= 1 && seqs * *groups <= INT_MAX;
}

template <typename T>
cudaError_t launch_two_seg(const T* y, const T* t, const int64_t* s1, const int64_t* s2,
                           const int64_t* split, T* m, int64_t B, int64_t n, int64_t A,
                           int64_t C, int64_t h1, int64_t mp, int64_t k, int64_t transpose,
                           int64_t warps, int64_t stages, cudaStream_t stream) {
  int64_t groups;
  if (!launch_shape(B, k, warps, stages, &groups) || n < 1 || A < 1 || C < 1 || h1 < 1 ||
      mp < A + h1 || mp > INT_MAX)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)(stages * (A + C) * (C | 1) + warps * (6 * A + 2 * C)) * sizeof(T);
  cudaError_t err = allow_smem(two_seg_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const TwoSegArgs g{(int)n, (int)A, (int)C, (int)h1, (int)k, (int)stages, (int)groups,
                     transpose ? 1 : 0, mp};
  two_seg_kernel<T><<<(unsigned)(B * groups), (unsigned)(32 * (warps + 1)), smem, stream>>>(
      y, t, s1, s2, split, m, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_solve(const T* ypad, const T* rp, const int64_t* cols, const int64_t* emit,
                         const int64_t* ncols, const uint8_t* active, T* xpad, int64_t B,
                         int64_t L, int64_t E, int64_t me, int64_t mc, int64_t rows, int64_t k,
                         int64_t warps, int64_t stages, cudaStream_t stream) {
  int64_t groups;
  if (!launch_shape(B, k, warps, stages, &groups) || L < 1 || me < 0 || me > E || mc < 1 ||
      me > mc || rows < mc || rows > INT_MAX)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)(stages * me * (mc | 1) + warps * (2 * mc + 4 * me)) * sizeof(T);
  cudaError_t err = allow_smem(banded_solve_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const SolveArgs g{(int)L, (int)E, (int)me, (int)mc, (int)k, (int)stages, (int)groups, rows};
  banded_solve_kernel<T><<<(unsigned)(B * groups), (unsigned)(32 * (warps + 1)), smem, stream>>>(
      ypad, rp, cols, emit, ncols, active, xpad, g);
  return cudaGetLastError();
}

// the grid of one phase of a level: its chunks × column groups (P1 over k
// plus the level's widest interface)
bool chunk_shape(int64_t nch, int64_t k, int64_t wl, int64_t wmax, int64_t mode, int64_t warps,
                 int64_t stages, int64_t* groups) {
  if (mode < kFirstPass || mode > kFinishAll || wl < 0 || wl > wmax || wmax < 1 || nch < 1)
    return false;
  return launch_shape(nch, mode == kFirstPass ? k + wl : k, warps, stages, groups);
}

template <typename T>
cudaError_t launch_two_seg_chunk(const T* y, const T* t, const int64_t* ls1, const int64_t* ls2,
                                 const int64_t* split, const int64_t* chunks, const int64_t* rows,
                                 const int64_t* iout, T* op, T* scr, const T* in, T* out,
                                 int64_t n, int64_t A, int64_t C, int64_t h1, int64_t mp, int64_t k,
                                 int64_t transpose, int64_t warps, int64_t stages, int64_t c_begin,
                                 int64_t nch, int64_t wmax, int64_t wl, int64_t mode,
                                 cudaStream_t stream) {
  int64_t groups;
  if (!chunk_shape(nch, k, wl, wmax, mode, warps, stages, &groups) || n < 1 || A < 1 || C < 1 ||
      h1 < 1 || mp < A + h1 || mp > INT_MAX || c_begin < 0 || c_begin + nch > INT_MAX)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)(stages * (A + C) * (C | 1) + warps * (6 * A + 2 * C)) * sizeof(T);
  cudaError_t err = allow_smem(two_seg_chunk_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const TwoSegArgs g{(int)n, (int)A, (int)C, (int)h1, (int)k, (int)stages, (int)groups,
                     transpose ? 1 : 0, mp};
  const ChunkArgs a{k, mp, (int)c_begin, (int)groups, (int)wmax, (int)mode};
  two_seg_chunk_kernel<T><<<(unsigned)(nch * groups), (unsigned)(32 * (warps + 1)), smem, stream>>>(
      y, t, ls1, ls2, split, chunks, rows, iout, op, scr, in, out, g, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_solve_chunk(const T* ypad, const T* rp, const int64_t* cols,
                               const int64_t* xcols, const int64_t* emit, const int64_t* ncols,
                               const uint8_t* active, const int64_t* chunks, const int64_t* rows,
                               const int64_t* iout, T* xpad, T* scr, const T* in, T* out,
                               int64_t L, int64_t E, int64_t me, int64_t mc, int64_t nrows,
                               int64_t k, int64_t warps, int64_t stages, int64_t c_begin,
                               int64_t nch, int64_t wmax, int64_t wl, int64_t mode,
                               cudaStream_t stream) {
  int64_t groups;
  if (!chunk_shape(nch, k, wl, wmax, mode, warps, stages, &groups) || L < 1 || me < 0 || me > E ||
      mc < 1 || me > mc || nrows < mc || nrows > INT_MAX || c_begin < 0 ||
      c_begin + nch > INT_MAX)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)(stages * me * (mc | 1) + warps * (2 * mc + 4 * me)) * sizeof(T);
  cudaError_t err = allow_smem(solve_chunk_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const SolveArgs g{(int)L, (int)E, (int)me, (int)mc, (int)k, (int)stages, (int)groups, nrows};
  const ChunkArgs a{k, nrows, (int)c_begin, (int)groups, (int)wmax, (int)mode};
  solve_chunk_kernel<T><<<(unsigned)(nch * groups), (unsigned)(32 * (warps + 1)), smem, stream>>>(
      ypad, rp, cols, xcols, emit, ncols, active, chunks, rows, iout, xpad, scr, in, out, g, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_join(const int64_t* chunks, const T* out, T* in, int64_t c_begin,
                        int64_t c_end, int64_t k, int64_t wmax, cudaStream_t stream) {
  if (k < 1 || wmax < 1 || c_begin < 0 || c_end <= c_begin || c_end > INT_MAX || wmax > 64 ||
      (k + kJoinCols - 1) / kJoinCols > INT_MAX)
    return cudaErrorInvalidValue;
  const size_t smem = 2 * kJoinStages * sizeof(int64_t) +
                      (size_t)(kJoinStages * wmax * (kJoinCols + wmax) + 2 * wmax * kJoinCols) * sizeof(T);
  cudaError_t err = allow_smem(chunk_join_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const JoinArgs a{k, (int)c_begin, (int)c_end, (int)wmax};
  chunk_join_kernel<T><<<(unsigned)((k + kJoinCols - 1) / kJoinCols), 32, smem, stream>>>(chunks,
                                                                                       out, in, a);
  return cudaGetLastError();
}

// Makes `device` current for the guard's lifetime, then the caller's device
// again (the same guard as banded_chain.cu's: this library's static CUDA
// runtime and PyTorch's follow the thread's current context).
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  bool switched_ = false;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py).  Each launcher makes
// `device` current, enqueues one kernel on the caller's stream of that
// device, makes the caller's device current again, does not synchronize,
// allocates nothing, and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for a geometry it does not take).
#define QRK_ON_DEVICE(device)                  \
  const DeviceGuard device_guard_(device);     \
  if (device_guard_.error() != cudaSuccess) return (int)device_guard_.error()

extern "C" {

int qrk_chain_two_seg_f32(int device, const float* y, const float* t, const int64_t* s1,
                          const int64_t* s2, const int64_t* split, float* m, int64_t B,
                          int64_t n, int64_t A, int64_t C, int64_t h1, int64_t mp, int64_t k,
                          int64_t transpose, int64_t warps, int64_t stages,
                          cudaStream_t stream) {
  QRK_ON_DEVICE(device);
  return (int)launch_two_seg<float>(y, t, s1, s2, split, m, B, n, A, C, h1, mp, k, transpose,
                                    warps, stages, stream);
}

int qrk_chain_two_seg_f64(int device, const double* y, const double* t, const int64_t* s1,
                          const int64_t* s2, const int64_t* split, double* m, int64_t B,
                          int64_t n, int64_t A, int64_t C, int64_t h1, int64_t mp, int64_t k,
                          int64_t transpose, int64_t warps, int64_t stages,
                          cudaStream_t stream) {
  QRK_ON_DEVICE(device);
  return (int)launch_two_seg<double>(y, t, s1, s2, split, m, B, n, A, C, h1, mp, k, transpose,
                                     warps, stages, stream);
}

int qrk_chain_solve_f32(int device, const float* ypad, const float* rp, const int64_t* cols,
                        const int64_t* emit, const int64_t* ncols, const uint8_t* active,
                        float* xpad, int64_t B, int64_t L, int64_t E, int64_t me, int64_t mc,
                        int64_t rows, int64_t k, int64_t warps, int64_t stages,
                        cudaStream_t stream) {
  QRK_ON_DEVICE(device);
  return (int)launch_solve<float>(ypad, rp, cols, emit, ncols, active, xpad, B, L, E, me, mc,
                                  rows, k, warps, stages, stream);
}

int qrk_chain_solve_f64(int device, const double* ypad, const double* rp, const int64_t* cols,
                        const int64_t* emit, const int64_t* ncols, const uint8_t* active,
                        double* xpad, int64_t B, int64_t L, int64_t E, int64_t me, int64_t mc,
                        int64_t rows, int64_t k, int64_t warps, int64_t stages,
                        cudaStream_t stream) {
  QRK_ON_DEVICE(device);
  return (int)launch_solve<double>(ypad, rp, cols, emit, ncols, active, xpad, B, L, E, me, mc,
                                   rows, k, warps, stages, stream);
}

#define QRK_CHAIN_CHUNK(sfx, T)                                                                    \
  int qrk_chain_two_seg_chunk_##sfx(                                                               \
      int device, const T* y, const T* t, const int64_t* ls1, const int64_t* ls2,                  \
      const int64_t* split, const int64_t* chunks, const int64_t* rows, const int64_t* iout, T* op, \
      T* scr, const T* in, T* out, int64_t n, int64_t A, int64_t C, int64_t h1, int64_t mp,        \
      int64_t k, int64_t transpose, int64_t warps, int64_t stages, int64_t c_begin, int64_t nch,   \
      int64_t wmax, int64_t wl, int64_t mode, cudaStream_t stream) {                               \
    QRK_ON_DEVICE(device);                                                                         \
    return (int)launch_two_seg_chunk<T>(y, t, ls1, ls2, split, chunks, rows, iout, op, scr, in,   \
                                        out, n, A, C, h1, mp, k, transpose, warps, stages,         \
                                        c_begin, nch, wmax, wl, mode, stream);                     \
  }                                                                                                \
  int qrk_chain_solve_chunk_##sfx(                                                                 \
      int device, const T* ypad, const T* rp, const int64_t* cols, const int64_t* xcols,           \
      const int64_t* emit, const int64_t* ncols, const uint8_t* active, const int64_t* chunks,     \
      const int64_t* rows, const int64_t* iout, T* xpad, T* scr, const T* in, T* out, int64_t L,   \
      int64_t E, int64_t me, int64_t mc, int64_t nrows, int64_t k, int64_t warps, int64_t stages,  \
      int64_t c_begin, int64_t nch, int64_t wmax, int64_t wl, int64_t mode,                        \
      cudaStream_t stream) {                                                                       \
    QRK_ON_DEVICE(device);                                                                         \
    return (int)launch_solve_chunk<T>(ypad, rp, cols, xcols, emit, ncols, active, chunks, rows,   \
                                      iout, xpad, scr, in, out, L, E, me, mc, nrows, k, warps,     \
                                      stages, c_begin, nch, wmax, wl, mode, stream);               \
  }                                                                                                \
  int qrk_chain_join_##sfx(int device, const int64_t* chunks, const T* out, T* in,                 \
                           int64_t c_begin, int64_t c_end, int64_t k, int64_t wmax,                \
                           cudaStream_t stream) {                                                  \
    QRK_ON_DEVICE(device);                                                                         \
    return (int)launch_join<T>(chunks, out, in, c_begin, c_end, k, wmax, stream);                  \
  }

QRK_CHAIN_CHUNK(f32, float)
QRK_CHAIN_CHUNK(f64, double)

const char* qrk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
