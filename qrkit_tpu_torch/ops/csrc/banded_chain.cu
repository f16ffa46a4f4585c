// Banded-chain panel QR for Hopper (sm_90a): the segment chains, the chain
// Q^T apply on a slab, and the single sequential chain.
//
// Replaces the Pallas TPU kernels in qrkit_tpu/ops/pallas_banded.py:
//   chain_reg_kernel / chain_smem_kernel  <- _chain_kernel (:61-145), called
//       per segment (qrk_banded_segment_chains_*), and <- _seq_chain_kernel
//       (:325-407), one chain (qrk_banded_chain_qr_*); both run the same
//       per-step math, so one pair of kernels serves both
//   apply_w_reg_kernel / apply_w_smem_kernel  <- _apply_w_kernel (:148-245)
//
// Layouts (chain index first, nothing padded; ops/banded.py documents them):
//   panels, y  [chains, steps, ma, mc]    entry (r, c) of a step's panel at r*mc + c
//   act        [chains, steps]            > 0.5: active step
//   tau        [chains, steps, mc]
//   v          [chains, steps, me, mc]    triu(R)[:me]
//   w, wq      [S, L, ma, ko]             window rows of the operand columns
//   ab         [L, 2] int32               per-step window starts (a_l, b_l)
//
// Per step of a chain: add the R-overlap carry to the panel's first mca rows,
// Householder QR column by column (Eigen's conventions: beta = -sign(x0)*norm,
// tau = (beta - x0)/beta, unit-diagonal reflector v, a degenerate column gets
// tau = 0), emit Y, tau and the leading me rows of triu(R), and cut the next
// carry triu(R)[cix:cix+mca, cix:cix+mc] (zero outside R), with cix the
// chain's first-step increment on step 0 and the body increment after it.
// Inactive steps emit zeros and keep the carry (their arithmetic is skipped:
// nothing of it is read).
//
// Bound: latency.  A step is a serial chain of mc column reductions and the
// steps are serial; a config-3 step (48 x 8, fp32) reads 1.5 KB.  The design
// keeps the serial path free of device-memory latency and of CTA barriers:
//
// chain_reg_kernel<T, RPL, MC> (narrow panels: ma <= 32*RPL, RPL <= 3,
// mc <= MC <= 32, the panel within 32 registers a lane): one warp per chain,
// the panel in registers, lane t owning rows t, t+32, ... for all columns.
// The next step's panel rows and activity flag are loaded into a second set
// of registers while the current step computes.  Column j: the partial sums
// of a(r,j)*a(r,c) over the rows r > j, for c = j (sigma) and every trailing
// column c > j, go through one shuffle butterfly together; row j comes from
// its owner lane by __shfl_sync.  Every lane then forms beta, tau and the
// reflector redundantly, and v^T a_c = a(j,c) + sum_{r>j} a(r,j) a(r,c) /
// (x0 - beta), so one butterfly a column suffices.  The rank-1 update stays in
// registers.  The carry crosses lanes (rows shift by cix) through a small
// shared-memory stage with an odd row stride and __syncwarp.  No
// __syncthreads in the step loop.
//
// chain_smem_kernel<T> (everything else: the 88 x 32 boundary chain, large
// panels, fp64 at large mc): 32*nw threads, the panel in shared memory
// column-major with an odd column stride (lanes on consecutive rows: no bank
// conflicts), two panel buffers, the next step's panel copied in with
// cp.async while the current step computes.  Warp w owns columns j+1+w,
// j+1+w+nw, ...; every warp forms column j's reflector itself from shared
// memory (sigma in the same butterfly as its columns' dot products), so a
// column costs one CTA barrier.  R's diagonal goes to its own array, so the
// pivot column is never written while other warps read it; Y is written
// once a step, coalesced, from the columns and the reflectors' reciprocals.
//
// apply_w_reg_kernel<T, RPL, MC, CPW> (ma <= 32*RPL, the same register
// budget, ko <= 32): one CTA per segment of at most 8 warps, each warp
// owning CPW operand columns (1 up to ko = 8, else 4), lanes over the ma
// window rows in registers.  Each lane reads only its own rows of Y and
// every tau straight from device memory, together with its window feed
// rows, one step ahead.  The warp's columns of the position-indexed work
// buffer W (wrows rows each, zeroed at the start; rows at positions >= h are
// never written and read as zero) live in shared memory; warps own
// disjoint columns, so __syncwarp orders a step's write-back against the
// next step's window read.  Per step: read the window (head rows at
// min(a, h) + r, tail rows at min(b, h) + r - mca) plus the first-touch
// operand rows, apply the mc reflectors (w -= v (tau (v^T w)), rows >= j;
// the warp's columns share one butterfly a reflector), emit every row,
// write back the rows whose unclamped positions lie below h.
//
// Every multi-warp kernel runs at most 8 warps and says so with
// __launch_bounds__(256, 1): 256 threads at ptxas's 255-register ceiling fit
// the 64K registers of an SM, so no instantiation can be refused its launch
// for registers (the minimum of one CTA an SM leaves ptxas free below that
// ceiling; without it ptxas cut chain_smem_kernel<float> to 48 and spilled).
//
// apply_w_smem_kernel<T> (everything else): the same algebra with the
// window in shared memory and Y read through the L1 cache, a warp looping
// over its columns.
//
// Numerics: correctly rounded division and sqrt, no FMA contraction
// (--fmad=false).  A column takes two divisions (tau and 1/(x0 - beta)); the
// reflector's tail and v^T a_c multiply by that reciprocal, and the plain
// version (ops/banded.py, _panel_qr) computes the same expressions.  The
// reductions add in another order (shuffle butterflies), so the results
// agree to rounding, not to the bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC   (ops/_build.py, one library for all shapes)

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRowsPerLane = 3;  // register kernels: ma <= 96
constexpr int kMaxRegCols = 32;     // register kernels: mc <= 32
constexpr int kRegWords = 32;       // register kernels: RPL * MC 32-bit words a lane
constexpr int kSmemChunk = 4;       // chain_smem_kernel: columns per butterfly
constexpr int kRowUnroll = 4;       // chain_smem_kernel: rows a lane keeps in flight
constexpr int kMaxWarps = 8;        // warps of a CTA in every multi-warp kernel
constexpr int kApplyCols = 4;       // apply_w_reg_kernel: operand columns a warp owns past ko = 8

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x = x + __shfl_xor_sync(kFull, x, m);
  return x;
}

// Householder scalars of a column from its pivot x0 and sigma = sum of the
// squares below it: tau, and the reciprocal of the reflector tail's divisor
// (x0 - beta; 1 for a degenerate column).  Each is one correctly rounded
// division: the kernels multiply by inv rather than divide element by
// element, because every IEEE division is its own basic block (a slow-path
// branch) that a lone warp executes serially.
template <typename T>
struct Reflector {
  T tau, inv;
};

template <typename T>
__device__ __forceinline__ Reflector<T> make_reflector(T x0, T sigma) {
  const T norm = sqrt(x0 * x0 + sigma);
  const T beta = x0 >= T(0) ? -norm : norm;
  const bool degen = sigma <= T(0);
  const T safe_beta = norm == T(0) ? T(1) : beta;
  return {degen ? T(0) : (beta - x0) / safe_beta, degen ? T(1) : T(1) / (x0 - beta)};
}

struct ChainArgs {
  int steps, ma, mc, mca, me, ci, ci_first0, ci_first_rest;
};

// This warp's rows of one panel (rows >= ma and columns >= mc read as 0).
template <typename T, int RPL, int MC>
__device__ __forceinline__ void load_rows(T (&dst)[RPL][MC], const T* __restrict__ p, int ma,
                                          int mc, int lane) {
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    const int r = lane + 32 * k;
#pragma unroll
    for (int c = 0; c < MC; ++c) dst[k][c] = (r < ma && c < mc) ? p[r * mc + c] : T(0);
  }
}

template <typename T>
__device__ __forceinline__ void zero_step(T* yl, T* tl, T* vl, int pe, int mc, int emit, int tid,
                                          int nthreads) {
  for (int i = tid; i < pe; i += nthreads) yl[i] = T(0);
  for (int i = tid; i < mc; i += nthreads) tl[i] = T(0);
  for (int i = tid; i < emit; i += nthreads) vl[i] = T(0);
}

template <typename T, int RPL, int MC>
__global__ void __launch_bounds__(32)
    chain_reg_kernel(const T* __restrict__ panels, const T* __restrict__ act, T* __restrict__ y,
                     T* __restrict__ tau, T* __restrict__ v, ChainArgs g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int SP = MC + 1;  // odd stage row stride: lanes on consecutive rows
  T* stage = reinterpret_cast<T*>(smem_raw);  // [mca][SP] carry rows of triu(R)

  const int lane = threadIdx.x;
  const int chain = blockIdx.x;
  const int ma = g.ma, mc = g.mc, mca = g.mca, me = g.me;
  const int pe = ma * mc;
  const int ci_first = chain == 0 ? g.ci_first0 : g.ci_first_rest;
  panels += (int64_t)chain * g.steps * pe;
  y += (int64_t)chain * g.steps * pe;
  act += (int64_t)chain * g.steps;
  tau += (int64_t)chain * g.steps * mc;
  v += (int64_t)chain * g.steps * me * mc;

  T carry[RPL][MC];
#pragma unroll
  for (int k = 0; k < RPL; ++k)
#pragma unroll
    for (int c = 0; c < MC; ++c) carry[k][c] = T(0);
  T nxt[RPL][MC];
  load_rows(nxt, panels, ma, mc, lane);
  T act_nxt = act[0];

  for (int l = 0; l < g.steps; ++l) {
    T a[RPL][MC];
#pragma unroll
    for (int k = 0; k < RPL; ++k)
#pragma unroll
      for (int c = 0; c < MC; ++c) a[k][c] = nxt[k][c];
    const bool active = act_nxt > T(0.5);
    if (l + 1 < g.steps) {  // step l+1's loads fly while step l computes
      load_rows(nxt, panels + (int64_t)(l + 1) * pe, ma, mc, lane);
      act_nxt = act[l + 1];
    }
    T* yl = y + (int64_t)l * pe;
    T* tl = tau + (int64_t)l * mc;
    T* vl = v + (int64_t)l * me * mc;
    if (!active) {
      zero_step(yl, tl, vl, pe, mc, me * mc, lane, 32);
      continue;
    }
#pragma unroll
    for (int k = 0; k < RPL; ++k)
#pragma unroll
      for (int c = 0; c < MC; ++c) a[k][c] = a[k][c] + carry[k][c];

#pragma unroll
    for (int j = 0; j < MC; ++j) {
      if (j >= mc) continue;
      if (j >= ma) {  // no pivot row: a zero reflector
        for (int r = lane; r < ma; r += 32) yl[r * mc + j] = T(0);
        if (lane == 0) tl[j] = T(0);
        continue;
      }
      T p[MC];  // p[j] = sigma, p[c > j] = sum_{r>j} a(r,j) a(r,c)
#pragma unroll
      for (int c = j; c < MC; ++c) p[c] = T(0);
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        const T wk = lane + 32 * k > j ? a[k][j] : T(0);
#pragma unroll
        for (int c = j; c < MC; ++c) p[c] = p[c] + wk * a[k][c];
      }
      T rowj[MC];  // row j (MC <= 32: its owner is lane j in register row 0)
#pragma unroll
      for (int c = j; c < MC; ++c) rowj[c] = __shfl_sync(kFull, a[0][c], j);
#pragma unroll
      for (int m = 16; m > 0; m >>= 1)
#pragma unroll
        for (int c = j; c < MC; ++c) p[c] = p[c] + __shfl_xor_sync(kFull, p[c], m);
      const Reflector<T> h = make_reflector(rowj[j], p[j]);
      T s[MC];  // tau * v^T a_c
#pragma unroll
      for (int c = j; c < MC; ++c) s[c] = h.tau * (rowj[c] + p[c] * h.inv);
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        const int r = lane + 32 * k;
        const T vk = r > j ? a[k][j] * h.inv : (r == j ? T(1) : T(0));
        if (r < ma) yl[r * mc + j] = vk;
#pragma unroll
        for (int c = j; c < MC; ++c) a[k][c] = a[k][c] - vk * s[c];
      }
      if (lane == 0) tl[j] = h.tau;
    }

#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int r = lane + 32 * k;
      if (r < me)
#pragma unroll
        for (int c = 0; c < MC; ++c)
          if (c < mc) vl[r * mc + c] = c >= r ? a[k][c] : T(0);
    }
    // the next carry: rows [cix, cix + mca) of triu(R), shifted up and left
    // by cix; the rows move across lanes through the stage
    const int cix = l == 0 ? ci_first : g.ci;
    __syncwarp();  // the previous carry's reads of the stage are done
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int r = lane + 32 * k;
      const int i = r - cix;
      if (r < ma && i >= 0 && i < mca)
#pragma unroll
        for (int c = 0; c < MC; ++c) stage[i * SP + c] = c >= r ? a[k][c] : T(0);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int i = lane + 32 * k;
      const bool row_in = i < mca && cix + i < ma;
#pragma unroll
      for (int c = 0; c < MC; ++c) {
        const int cc = cix + c;
        carry[k][c] = (row_in && cc < MC) ? stage[i * SP + cc] : T(0);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    chain_smem_kernel(const T* __restrict__ panels, const T* __restrict__ act, T* __restrict__ y,
                      T* __restrict__ tau, T* __restrict__ v, ChainArgs g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ma = g.ma, mc = g.mc, mca = g.mca, me = g.me;
  const int cs = ma | 1;  // odd column stride
  T* buf0 = reinterpret_cast<T*>(smem_raw);  // [mc][cs] panel, column-major
  T* buf1 = buf0 + mc * cs;                   // the next step's panel
  T* carry = buf1 + mc * cs;                  // [mca][mc]
  T* diag = carry + mca * mc;                 // [mc] R's diagonal
  T* invs = diag + mc;                        // [mc] each reflector's 1/(x0 - beta)

  const int chain = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nthreads >> 5;
  const int pe = ma * mc;
  const int jmax = mc < ma ? mc : ma;
  const int ci_first = chain == 0 ? g.ci_first0 : g.ci_first_rest;
  panels += (int64_t)chain * g.steps * pe;
  y += (int64_t)chain * g.steps * pe;
  act += (int64_t)chain * g.steps;
  tau += (int64_t)chain * g.steps * mc;
  v += (int64_t)chain * g.steps * me * mc;

  // row-major panel -> column-major stage, element by element (a 3 x 1
  // fp32 panel is 12 bytes: no 16-byte bulk copy fits every geometry)
  auto fetch = [&](T* dst, const T* src) {
    for (int i = tid; i < pe; i += nthreads) {
      const int r = i / mc;
      __pipeline_memcpy_async(dst + (i - r * mc) * cs + r, src + i, sizeof(T));
    }
    __pipeline_commit();
  };

  for (int i = tid; i < mca * mc; i += nthreads) carry[i] = T(0);
  fetch(buf0, panels);

  for (int l = 0; l < g.steps; ++l) {
    T* P = (l & 1) ? buf1 : buf0;
    __pipeline_wait_prior(0);
    __syncthreads();  // step l's panel is in; step l-1 is done with the other buffer
    if (l + 1 < g.steps) fetch((l & 1) ? buf0 : buf1, panels + (int64_t)(l + 1) * pe);
    T* yl = y + (int64_t)l * pe;
    T* tl = tau + (int64_t)l * mc;
    T* vl = v + (int64_t)l * me * mc;
    if (!(act[l] > T(0.5))) {
      zero_step(yl, tl, vl, pe, mc, me * mc, tid, nthreads);
      continue;
    }
    for (int i = tid; i < mca * mc; i += nthreads) {
      const int r = i / mc, c = i - r * mc;
      P[c * cs + r] = P[c * cs + r] + carry[i];
    }
    __syncthreads();

    for (int j = 0; j < jmax; ++j) {
      const T* colj = P + j * cs;
      const T x0 = colj[j];
      Reflector<T> h{T(0), T(1)};
      // chunks of this warp's columns; the first also reduces sigma
      for (int c0 = j + 1 + warp, first = 1; first || c0 < mc; c0 += nw * kSmemChunk, first = 0) {
        T p[kSmemChunk + 1];
#pragma unroll
        for (int q = 0; q <= kSmemChunk; ++q) p[q] = T(0);
        for (int r0 = j + 1 + lane; r0 < ma; r0 += 32 * kRowUnroll)
#pragma unroll
          for (int u = 0; u < kRowUnroll; ++u) {
            const int r = r0 + 32 * u;
            if (r >= ma) break;
            const T w = colj[r];
            if (first) p[kSmemChunk] = p[kSmemChunk] + w * w;
#pragma unroll
            for (int q = 0; q < kSmemChunk; ++q) {
              const int c = c0 + nw * q;
              if (c < mc) p[q] = p[q] + w * P[c * cs + r];
            }
          }
#pragma unroll
        for (int m = 16; m > 0; m >>= 1)
#pragma unroll
          for (int q = 0; q <= kSmemChunk; ++q) p[q] = p[q] + __shfl_xor_sync(kFull, p[q], m);
        if (first) {
          h = make_reflector(x0, p[kSmemChunk]);
          if (tid == 0) {
            // R(j, j) = x0 - tau * v^T a_j
            diag[j] = x0 - h.tau * (x0 + p[kSmemChunk] * h.inv);
            invs[j] = h.inv;
            tl[j] = h.tau;
          }
        }
        T s[kSmemChunk];
#pragma unroll
        for (int q = 0; q < kSmemChunk; ++q) {
          const int c = c0 + nw * q;
          s[q] = c < mc ? h.tau * (P[c * cs + j] + p[q] * h.inv) : T(0);
        }
        __syncwarp();  // every lane has read row j before lane 0 writes it
        if (lane == 0)
#pragma unroll
          for (int q = 0; q < kSmemChunk; ++q)
            if (c0 + nw * q < mc) P[(c0 + nw * q) * cs + j] -= s[q];
        for (int r0 = j + 1 + lane; r0 < ma; r0 += 32 * kRowUnroll)
#pragma unroll
          for (int u = 0; u < kRowUnroll; ++u) {
            const int r = r0 + 32 * u;
            if (r >= ma) break;
            const T vr = colj[r] * h.inv;
#pragma unroll
            for (int q = 0; q < kSmemChunk; ++q)
              if (c0 + nw * q < mc) P[(c0 + nw * q) * cs + r] -= vr * s[q];
          }
      }
      __syncthreads();
    }
    for (int j = jmax + tid; j < mc; j += nthreads) tl[j] = T(0);  // no pivot row: tau = 0
    // Y off the column loop: a reflector's tail is its column below the
    // diagonal, which no later column changes
    for (int i = tid; i < pe; i += nthreads) {
      const int r = i / mc, c = i - r * mc;
      yl[i] = c >= jmax || r < c ? T(0) : (r == c ? T(1) : P[c * cs + r] * invs[c]);
    }

    for (int i = tid; i < me * mc; i += nthreads) {
      const int r = i / mc, c = i - r * mc;
      vl[i] = c > r ? P[c * cs + r] : (c == r ? diag[c] : T(0));
    }
    const int cix = l == 0 ? ci_first : g.ci;
    for (int i = tid; i < mca * mc; i += nthreads) {
      const int rr = i / mc + cix, cc = i - (i / mc) * mc + cix;
      carry[i] = (rr < ma && cc < mc && rr <= cc) ? (rr == cc ? diag[cc] : P[cc * cs + rr])
                                                  : T(0);
    }
  }
}

struct ApplyArgs {
  int L, ma, mc, mca, ko, h, wrows;
};

// Y, tau, the window starts and this warp's fed operand rows of one step
// (columns warp + nw*q; a column >= ko reads as 0)
template <typename T, int RPL, int MC, int CPW>
__device__ __forceinline__ void load_step(T (&yr)[RPL][MC], T (&tr)[MC], T (&wr)[CPW][RPL],
                                          int2& abr, const T* __restrict__ yl,
                                          const T* __restrict__ tl, const T* __restrict__ wl,
                                          const int32_t* __restrict__ abl, int ma, int mc, int ko,
                                          int warp, int nw, int lane) {
  load_rows(yr, yl, ma, mc, lane);
#pragma unroll
  for (int c = 0; c < MC; ++c) tr[c] = c < mc ? tl[c] : T(0);
#pragma unroll
  for (int q = 0; q < CPW; ++q) {
    const int col = warp + nw * q;
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int r = lane + 32 * k;
      wr[q][k] = (r < ma && col < ko) ? wl[r * ko + col] : T(0);
    }
  }
  abr = make_int2(abl[0], abl[1]);
}

template <typename T, int RPL, int MC, int CPW>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    apply_w_reg_kernel(const T* __restrict__ yf, const T* __restrict__ tauf,
                       const T* __restrict__ w, const int32_t* __restrict__ ab,
                       T* __restrict__ wq, ApplyArgs g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int s = blockIdx.x;
  const int ma = g.ma, mc = g.mc, mca = g.mca, ko = g.ko, h = g.h;
  const int pe = ma * mc, we = ma * ko;
  T* Wall = reinterpret_cast<T*>(smem_raw);  // [ko][wrows] work rows, column by column
#pragma unroll
  for (int q = 0; q < CPW; ++q) {
    const int col = warp + nw * q;
    if (col < ko)
      for (int i = lane; i < g.wrows; i += 32) Wall[col * g.wrows + i] = T(0);
  }

  const int64_t step0 = (int64_t)s * g.L;
  T ynx[RPL][MC], tnx[MC], wnx[CPW][RPL];
  int2 abnx;
  load_step(ynx, tnx, wnx, abnx, yf + step0 * pe, tauf + step0 * mc, w + step0 * we, ab, ma, mc,
            ko, warp, nw, lane);
  for (int l = 0; l < g.L; ++l) {
    T yr[RPL][MC], tr[MC], win[CPW][RPL];
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
#pragma unroll
      for (int q = 0; q < CPW; ++q) win[q][k] = wnx[q][k];
#pragma unroll
      for (int c = 0; c < MC; ++c) yr[k][c] = ynx[k][c];
    }
#pragma unroll
    for (int c = 0; c < MC; ++c) tr[c] = tnx[c];
    const int a = abnx.x, b = abnx.y;
    const int64_t step = step0 + l;
    if (l + 1 < g.L)  // step l+1's loads fly while step l computes
      load_step(ynx, tnx, wnx, abnx, yf + (step + 1) * pe, tauf + (step + 1) * mc,
                w + (step + 1) * we, ab + 2 * (l + 1), ma, mc, ko, warp, nw, lane);
    const int ac = a < h ? a : h, bc = b < h ? b : h;
    int row[RPL];
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int r = lane + 32 * k;
      row[k] = r < mca ? ac + r : bc + r - mca;
    }
    __syncwarp();  // the previous step's write-back is visible
#pragma unroll
    for (int q = 0; q < CPW; ++q) {
      const int col = warp + nw * q;
      if (col < ko)
#pragma unroll
        for (int k = 0; k < RPL; ++k)
          if (lane + 32 * k < ma) win[q][k] = Wall[col * g.wrows + row[k]] + win[q][k];
    }
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      if (j >= mc) continue;
      T p[CPW];  // v_j^T w of each of the warp's columns
#pragma unroll
      for (int q = 0; q < CPW; ++q) {
        p[q] = T(0);
#pragma unroll
        for (int k = 0; k < RPL; ++k)
          if (lane + 32 * k >= j) p[q] = p[q] + yr[k][j] * win[q][k];
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1)
#pragma unroll
        for (int q = 0; q < CPW; ++q) p[q] = p[q] + __shfl_xor_sync(kFull, p[q], m);
#pragma unroll
      for (int q = 0; q < CPW; ++q) {
        const T sc = tr[j] * p[q];
#pragma unroll
        for (int k = 0; k < RPL; ++k)
          if (lane + 32 * k >= j) win[q][k] = win[q][k] - yr[k][j] * sc;
      }
    }
    T* out = wq + step * we;
    __syncwarp();  // every lane has read its window rows
#pragma unroll
    for (int q = 0; q < CPW; ++q) {
      const int col = warp + nw * q;
      if (col >= ko) continue;
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        const int r = lane + 32 * k;
        if (r < ma) {
          out[r * ko + col] = win[q][k];
          // write back only positions below h: the pad rows [h, wrows) stay zero
          if ((r < mca ? a + r : b + r - mca) < h) Wall[col * g.wrows + row[k]] = win[q][k];
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    apply_w_smem_kernel(const T* __restrict__ yf, const T* __restrict__ tauf,
                        const T* __restrict__ w, const int32_t* __restrict__ ab,
                        T* __restrict__ wq, ApplyArgs g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int s = blockIdx.x;
  const int ma = g.ma, mc = g.mc, mca = g.mca, ko = g.ko, h = g.h;
  const int pe = ma * mc, we = ma * ko;
  const int jmax = mc < ma ? mc : ma;
  T* Wall = reinterpret_cast<T*>(smem_raw);        // [ko][wrows]
  T* win = Wall + ko * g.wrows + warp * ma;         // [ma] this warp's window
  for (int i = threadIdx.x; i < ko * g.wrows; i += blockDim.x) Wall[i] = T(0);
  __syncthreads();

  for (int l = 0; l < g.L; ++l) {
    const int64_t step = (int64_t)s * g.L + l;
    const int a = ab[2 * l], b = ab[2 * l + 1];
    const int ac = a < h ? a : h, bc = b < h ? b : h;
    const T* yl = yf + step * pe;
    const T* tl = tauf + step * mc;
    const T* wl = w + step * we;
    T* out = wq + step * we;
    for (int col = warp; col < ko; col += nw) {
      T* W = Wall + col * g.wrows;
      for (int r = lane; r < ma; r += 32)
        win[r] = W[r < mca ? ac + r : bc + r - mca] + wl[r * ko + col];
      __syncwarp();
      // each lane keeps its rows (lane, lane + 32, ...) for every reflector,
      // so no other lane's write is read without a __syncwarp
      for (int j = 0; j < jmax; ++j) {
        const int rj = j <= lane ? lane : lane + 32 * ((j - lane + 31) / 32);  // first own row >= j
        T p = T(0);
        for (int r = rj; r < ma; r += 32) p = p + yl[r * mc + j] * win[r];
        const T sc = tl[j] * warp_sum(p);
        for (int r = rj; r < ma; r += 32) win[r] = win[r] - yl[r * mc + j] * sc;
      }
      __syncwarp();
      for (int r = lane; r < ma; r += 32) {
        out[r * ko + col] = win[r];
        if ((r < mca ? a + r : b + r - mca) < h) W[r < mca ? ac + r : bc + r - mca] = win[r];
      }
      __syncwarp();
    }
  }
}

// ---- geometry and dispatch (ops/banded.py mirrors these rules exactly) ----

int rows_per_lane(int64_t ma) { return (int)((ma + 31) / 32); }

int pow2_at_least(int64_t n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename T>
constexpr bool reg_fits(int rpl, int mcp) {
  return rpl >= 1 && rpl <= kMaxRowsPerLane && mcp <= kMaxRegCols &&
         rpl * mcp * (int)sizeof(T) <= kRegWords * 4;
}

template <typename T>
bool use_reg(int64_t ma, int64_t mc) {
  return reg_fits<T>(rows_per_lane(ma), pow2_at_least(mc));
}

template <typename T, int RPL, int MC, typename F>
cudaError_t call_reg(F& f) {
  if constexpr (reg_fits<T>(RPL, MC)) {
    return f(std::integral_constant<int, RPL>{}, std::integral_constant<int, MC>{});
  } else {
    return cudaErrorInvalidValue;
  }
}

template <typename T, int RPL, typename F>
cudaError_t dispatch_mc(int mcp, F& f) {
  switch (mcp) {
    case 1: return call_reg<T, RPL, 1>(f);
    case 2: return call_reg<T, RPL, 2>(f);
    case 4: return call_reg<T, RPL, 4>(f);
    case 8: return call_reg<T, RPL, 8>(f);
    case 16: return call_reg<T, RPL, 16>(f);
    case 32: return call_reg<T, RPL, 32>(f);
  }
  return cudaErrorInvalidValue;
}

// f(integral_constant RPL, integral_constant MC) for the register kernel
// instantiation of this geometry
template <typename T, typename F>
cudaError_t dispatch_reg(int64_t ma, int64_t mc, F f) {
  const int mcp = pow2_at_least(mc);
  switch (rows_per_lane(ma)) {
    case 1: return dispatch_mc<T, 1>(mcp, f);
    case 2: return dispatch_mc<T, 2>(mcp, f);
    case 3: return dispatch_mc<T, 3>(mcp, f);
  }
  return cudaErrorInvalidValue;
}

int smem_chain_warps(int64_t mc) {
  const int64_t nw = (mc + kSmemChunk - 1) / kSmemChunk;
  return nw < 1 ? 1 : (nw > kMaxWarps ? kMaxWarps : (int)nw);
}

// above 48 KB a kernel's dynamic shared memory needs an opt-in
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
cudaError_t launch_chains(const T* panels, const T* act, T* y, T* tau, T* v, int64_t chains,
                          int64_t steps, int64_t ma, int64_t mc, int64_t mca, int64_t me,
                          int64_t ci, int64_t ci_first0, int64_t ci_first_rest,
                          cudaStream_t stream) {
  const ChainArgs g{(int)steps, (int)ma, (int)mc, (int)mca, (int)me, (int)ci, (int)ci_first0,
                    (int)ci_first_rest};
  if (use_reg<T>(ma, mc)) {
    return dispatch_reg<T>(ma, mc, [&](auto rpl, auto mcp) {
      constexpr int R = decltype(rpl)::value, M = decltype(mcp)::value;
      const size_t smem = (size_t)mca * (M + 1) * sizeof(T);
      cudaError_t err = allow_smem(chain_reg_kernel<T, R, M>, smem);
      if (err != cudaSuccess) return err;
      chain_reg_kernel<T, R, M><<<(unsigned)chains, 32, smem, stream>>>(panels, act, y, tau, v, g);
      return cudaGetLastError();
    });
  }
  const size_t smem = (size_t)(2 * mc * (ma | 1) + mca * mc + 2 * mc) * sizeof(T);
  cudaError_t err = allow_smem(chain_smem_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  chain_smem_kernel<T><<<(unsigned)chains, 32 * smem_chain_warps(mc), smem, stream>>>(
      panels, act, y, tau, v, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_apply_w(const T* y, const T* tau, const T* w, const int32_t* ab, T* wq,
                           int64_t S, int64_t L, int64_t ma, int64_t mc, int64_t mca, int64_t ko,
                           int64_t h, int64_t wrows, cudaStream_t stream) {
  const ApplyArgs g{(int)L, (int)ma, (int)mc, (int)mca, (int)ko, (int)h, (int)wrows};
  if (ko <= kMaxWarps * kApplyCols && use_reg<T>(ma, mc)) {
    const size_t smem = (size_t)ko * wrows * sizeof(T);
    const bool one_col = ko <= kMaxWarps;  // a warp per column, else kApplyCols a warp
    const unsigned threads = 32 * (unsigned)(one_col ? ko : (ko + kApplyCols - 1) / kApplyCols);
    return dispatch_reg<T>(ma, mc, [&](auto rpl, auto mcp) {
      constexpr int R = decltype(rpl)::value, M = decltype(mcp)::value;
      auto go = [&](auto kernel) {
        cudaError_t err = allow_smem(kernel, smem);
        if (err != cudaSuccess) return err;
        kernel<<<(unsigned)S, threads, smem, stream>>>(y, tau, w, ab, wq, g);
        return cudaGetLastError();
      };
      return one_col ? go(apply_w_reg_kernel<T, R, M, 1>)
                     : go(apply_w_reg_kernel<T, R, M, kApplyCols>);
    });
  }
  const int64_t nw = ko < kMaxWarps ? ko : kMaxWarps;
  const size_t smem = (size_t)(ko * wrows + nw * ma) * sizeof(T);
  cudaError_t err = allow_smem(apply_w_smem_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  apply_w_smem_kernel<T><<<(unsigned)S, (unsigned)(32 * nw), smem, stream>>>(y, tau, w, ab, wq, g);
  return cudaGetLastError();
}

// Makes `device` current for the guard's lifetime, then the caller's device
// again.  This library's CUDA runtime (linked statically) and PyTorch's both
// follow the thread's current CUDA context, so a switch left in place would
// move PyTorch's current device too.  Costs one cudaGetDevice when `device`
// is current already.  (The same guard as blockdiag_qr.cu's.)
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
// `device` (its operands' CUDA ordinal) current, enqueues one kernel on the
// caller's stream of that device, makes the caller's device current again
// (the guard's destructor, on return), does not synchronize, and returns
// cudaGetLastError() (0 on success).  The caller allocates every buffer and
// checks the shared-memory size (ops.banded.chain_smem_bytes /
// apply_w_smem_bytes, at most SMEM_LIMIT; above 48 KB the launcher opts in).
#define QRK_ON_DEVICE(device)                  \
  const DeviceGuard device_guard_(device);     \
  if (device_guard_.error() != cudaSuccess) return (int)device_guard_.error()

extern "C" {

// S chains of L steps; chain 0's first step cuts its carry at ci, the
// first step of chains >= 1 at ci0_rest (their dropped leading overlap).
int qrk_banded_segment_chains_f32(int device, const float* panels, const float* act, float* y,
                                  float* tau, float* v, int64_t S, int64_t L, int64_t ma,
                                  int64_t mc, int64_t mca, int64_t me, int64_t ci,
                                  int64_t ci0_rest, cudaStream_t stream) {
  QRK_ON_DEVICE(device);
  return (int)launch_chains<float>(panels, act, y, tau, v, S, L, ma, mc, mca, me, ci, ci,
                                   ci0_rest, stream);
}

int qrk_banded_segment_chains_f64(int device, const double* panels, const double* act,
                                  double* y, double* tau, double* v, int64_t S, int64_t L,
                                  int64_t ma, int64_t mc, int64_t mca, int64_t me, int64_t ci,
                                  int64_t ci0_rest, cudaStream_t stream) {
  QRK_ON_DEVICE(device);
  return (int)launch_chains<double>(panels, act, y, tau, v, S, L, ma, mc, mca, me, ci, ci,
                                    ci0_rest, stream);
}

// One chain of nb steps; its first step cuts the carry at ci0.
int qrk_banded_chain_qr_f32(int device, const float* panels, const float* act, float* y,
                            float* tau, float* v, int64_t nb, int64_t ma, int64_t mc,
                            int64_t mca, int64_t me, int64_t ci, int64_t ci0,
                            cudaStream_t stream) {
  QRK_ON_DEVICE(device);
  return (int)launch_chains<float>(panels, act, y, tau, v, 1, nb, ma, mc, mca, me, ci, ci0, ci0,
                                   stream);
}

int qrk_banded_chain_qr_f64(int device, const double* panels, const double* act, double* y,
                            double* tau, double* v, int64_t nb, int64_t ma, int64_t mc,
                            int64_t mca, int64_t me, int64_t ci, int64_t ci0,
                            cudaStream_t stream) {
  QRK_ON_DEVICE(device);
  return (int)launch_chains<double>(panels, act, y, tau, v, 1, nb, ma, mc, mca, me, ci, ci0, ci0,
                                    stream);
}

int qrk_banded_apply_w_f32(int device, const float* y, const float* tau, const float* w,
                           const int32_t* ab, float* wq, int64_t S, int64_t L, int64_t ma,
                           int64_t mc, int64_t mca, int64_t ko, int64_t h, int64_t wrows,
                           cudaStream_t stream) {
  QRK_ON_DEVICE(device);
  return (int)launch_apply_w<float>(y, tau, w, ab, wq, S, L, ma, mc, mca, ko, h, wrows, stream);
}

int qrk_banded_apply_w_f64(int device, const double* y, const double* tau, const double* w,
                           const int32_t* ab, double* wq, int64_t S, int64_t L, int64_t ma,
                           int64_t mc, int64_t mca, int64_t ko, int64_t h, int64_t wrows,
                           cudaStream_t stream) {
  QRK_ON_DEVICE(device);
  return (int)launch_apply_w<double>(y, tau, w, ab, wq, S, L, ma, mc, mca, ko, h, wrows, stream);
}

const char* qrk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
