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
// (two_segment_apply, banded_solve_chunk) launch these kernels.
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
// few us.  The design keeps device-memory latency off the serial path
// where it can:
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
// No atomics and a fixed order of every sum, so a call is deterministic.
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

template <typename T>
__global__ void __launch_bounds__(256)
    two_seg_kernel(const T* __restrict__ y, const T* __restrict__ t,
                   const int64_t* __restrict__ s1, const int64_t* __restrict__ s2,
                   const int64_t* __restrict__ split, T* __restrict__ m, TwoSegArgs g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
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

  const int64_t b = blockIdx.x / g.col_groups;
  const int64_t col0 = (int64_t)(blockIdx.x % g.col_groups) * nw;
  const int ncol = (int)(g.k - col0 < nw ? g.k - col0 : nw);  // live column warps
  const bool live = warp < ncol;
  const int64_t k = g.k;
  T* mb = m + b * g.mp * g.k + col0;  // column w of this CTA at mb[r * k + w]
  const T* yb = y + b * g.n * (int64_t)A * C;
  const T* tb = t + b * g.n * (int64_t)C * C;
  s1 += b * g.n;
  s2 += b * g.n;
  split += b * g.n;
  int cp = 1;
  while (cp < C && cp < 32) cp <<= 1;
  const int groups = 32 / cp, grp = lane / cp, cl = lane % cp;
  const int spmax = g.h1 < A ? g.h1 : A;

  auto step_of = [&](int i) { return g.transpose ? i : g.n - 1 - i; };
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
  TwoSegStep nxt = g.n > 1 ? load_step(1) : cur;
  if (stager) {
    prefetch(0, cur, false, cur);
    if (g.stages == 2) fetch(sm, 0);
  }
  __pipeline_commit();
  for (int i = 0; i < g.n; ++i) {
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
      if (i + 1 < g.n) {
        if (g.stages == 2) fetch(sm + (q ^ 1) * stage, i + 1);
        prefetch(nset, nxt, true, cur);
      }
    }
    __pipeline_commit();
    const TwoSegStep after = i + 2 < g.n ? load_step(i + 2) : nxt;  // loads fly during the step
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
      if (i + 1 < g.n) {
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
  if (stager) store((g.n - 1) % 3, prev);
}

template <typename T>
__global__ void __launch_bounds__(256)
    banded_solve_kernel(const T* __restrict__ ypad, const T* __restrict__ rp,
                        const int64_t* __restrict__ cols, const int64_t* __restrict__ emit,
                        const int64_t* __restrict__ ncols, const uint8_t* __restrict__ active,
                        T* __restrict__ xpad, SolveArgs g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
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

  const int64_t b = blockIdx.x / g.col_groups;
  const int64_t col = (int64_t)(blockIdx.x % g.col_groups) * nw + warp;
  const bool live = !stager && col < g.k;
  const int64_t k = g.k;
  const T* yc = ypad + b * g.rows * k + col;
  T* xc = xpad + b * g.rows * k + col;
  const T* rb = rp + b * g.L * (int64_t)g.E * mc;
  cols += b * g.L;
  emit += b * g.L;
  ncols += b * g.L;
  active += b * g.L;

  struct Step {
    int c0, er, nc;  // rows below 2^31 (the launcher checks)
    int lr;          // live rows: er within [0, me]
    bool act;
  };
  auto load_step = [&](int i) {
    const int l = g.L - 1 - i;
    const int64_t er = emit[l], nc = ncols[l];
    const int erc = (int)(er < 0 ? -1 : (er > mc ? mc : er));
    return Step{(int)cols[l], erc, (int)(nc < 0 ? -1 : (nc > mc ? mc : nc)),
                (int)(er < 0 ? 0 : (er > me ? me : er)), active[l] != 0};
  };
  auto fetch = [&](T* dst, int i) {
    if (stager) stage_rows(dst, rb + (int64_t)(g.L - 1 - i) * g.E * mc, me, mc, ms, lane, 32);
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
        __pipeline_memcpy_async(xwb + q * mc + c, xc + (int64_t)r * k, sizeof(T));
    }
    for (int r = lane; r < nx.lr; r += 32)
      __pipeline_memcpy_async(yvb + q * me + r, yc + (int64_t)(nx.c0 + r) * k, sizeof(T));
  };
  auto fill = [&](int q, const Step& nx, const Step& cur) {
    for (int c = lane; c < mc; c += 32) {
      const int r = nx.c0 + c;
      if (c >= nx.er && c < nx.nc && writes(cur, r)) xwb[q * mc + c] = solved[r - cur.c0];
    }
  };

  Step cur = load_step(0);
  Step nxt = g.L > 1 ? load_step(1) : cur;
  prefetch(0, cur, false, cur);
  if (g.stages == 2) fetch(sm, 0);
  __pipeline_commit();
  for (int i = 0; i < g.L; ++i) {
    const int q = i & 1;
    const T* v;
    if (g.stages == 2) {
      v = sm + q * stage;
      __pipeline_wait_prior(0);
      __syncthreads();
      if (i + 1 < g.L) {
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
      if (i + 1 < g.L) prefetch(q ^ 1, nxt, true, cur);
      __pipeline_commit();
    }
    const Step after = i + 2 < g.L ? load_step(i + 2) : nxt;
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
          if (cur.act) xc[(int64_t)(cur.c0 + lane) * k] = x_own;
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
            if (cur.act) xc[(int64_t)(cur.c0 + rr) * k] = x;
          }
          for (int r = lane; r < rr; r += 32) rhs[r] = rhs[r] - v[r * ms + rr] * x;
          __syncwarp();
        }
      }
      __syncwarp();  // every solved row is in place
      if (i + 1 < g.L) fill(q ^ 1, nxt, cur);
      __syncwarp();  // the next step's window is in place
    }
    cur = nxt;
    nxt = after;
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

const char* qrk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
