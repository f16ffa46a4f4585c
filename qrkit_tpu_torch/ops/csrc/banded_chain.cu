// Banded-chain panel QR for Hopper (sm_90a): the segment chains, the chain
// Q^T apply on a slab, and the single sequential chain.
//
// Replaces the Pallas TPU kernels in qrkit_tpu/ops/pallas_banded.py:
//   banded_chain_kernel   <- _chain_kernel (:61-145), called per segment
//                            (qrk_banded_segment_chains_*), and
//                         <- _seq_chain_kernel (:325-407), one chain
//                            (qrk_banded_chain_qr_*); both run the same
//                            per-step math, so one kernel serves both
//   banded_apply_w_kernel <- _apply_w_kernel (:148-245)
//
// Layouts (chain index first, nothing padded; ops/banded.py documents them):
//   panels, y  [chains, steps, ma, mc]    entry (r, c) of a step's panel at r*mc + c
//   act        [chains, steps]            > 0.5: active step
//   tau        [chains, steps, mc]
//   v          [chains, steps, me, mc]    triu(R)[:me]
//   w, wq      [S, L, ma, ko]             window rows of the operand columns
//   ab         [L, 2] int32               per-step window starts (a_l, b_l)
//
// banded_chain_kernel: one CTA per chain, 32*nw threads, a loop over the
// chain's steps inside the kernel (the TPU grid's sequential step axis).  The
// panel (ma x mc) and the R-overlap carry (mca x mc) live in shared memory.
// Per step: load the panel coalesced and add the carry to its first mca
// rows; then for each column j, warp 0 reduces sigma over the rows below the
// diagonal (lanes stride the rows, a shuffle butterfly sums, so every lane
// holds the same value), forms beta, tau and the unit-diagonal reflector v
// (Eigen's conventions: beta = -sign(x0)*norm, tau = (beta - x0)/beta,
// a degenerate column gets tau = 0), and writes Y's column j; after a
// barrier each warp takes columns c = j + warp, j + warp + nw, ... < mc and
// applies H = I - tau v v^T to them (a dot product over the rows by the
// same butterfly, then the rank-1 update).  The step ends by emitting the
// leading me rows of triu(R) and cutting the next carry
// triu(R)[cix:cix+mca, cix:cix+mc] (zero outside R), with cix the chain's
// first-step increment on step 0 and the body increment after it.
// Inactive steps emit zeros and keep the carry.
//
// Bound: latency, not bandwidth.  Each column is a serial chain of a
// reduction, a sqrt, a division and a second reduction; a config-3 step
// (48 x 8) reads 1.5 KB.  One CTA per chain spreads the 79 segments of
// config 3 over 79 SMs; more warps per CTA shorten each column's update.
// Overlapping the next step's load with the current step is later work.
//
// banded_apply_w_kernel: one CTA per segment, one thread per operand column
// (operand columns are independent under a reflector).  Each thread keeps
// its column of the position-indexed work buffer W (wrows rows, zeroed at
// the start; rows at positions >= h are never written and read as zero) and
// its ma window rows in shared memory; the step's Y and tau are staged in
// shared memory by the whole CTA.  Per step: read the window (head rows at
// min(a, h) + r, tail rows at min(b, h) + r - mca) plus the first-touch
// operand rows, apply the mc reflectors one by one
// (w -= v (tau (v^T w)), rows >= j), emit every row, and write back the rows
// whose positions lie below h.  Bound: latency of the per-thread serial
// loop; config 3 is 79 CTAs of 8 columns.
//
// Numerics: true division and sqrt, no FMA contraction (--fmad=false).  The
// reductions add in another order than the plain versions' (shuffle
// butterfly, strided lanes), so the results agree to rounding, not to the
// bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC   (ops/_build.py, one library for all shapes)

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxWarps = 8;

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x = x + __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

template <typename T>
__global__ void banded_chain_kernel(const T* __restrict__ panels, const T* __restrict__ act,
                                    T* __restrict__ y, T* __restrict__ tau, T* __restrict__ v,
                                    int steps, int ma, int mc, int mca, int me, int ci,
                                    int ci_first0, int ci_first_rest) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);  // [ma][mc] current panel
  T* carry = sh + ma * mc;                  // [mca][mc]
  T* vv = carry + mca * mc;                 // [ma] current reflector
  T* scal = vv + ma;                        // [1] current tau

  const int chain = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nthreads >> 5;
  const int pe = ma * mc;
  const int ci_first = chain == 0 ? ci_first0 : ci_first_rest;

  panels += (int64_t)chain * steps * pe;
  y += (int64_t)chain * steps * pe;
  act += (int64_t)chain * steps;
  tau += (int64_t)chain * steps * mc;
  v += (int64_t)chain * steps * me * mc;

  for (int i = tid; i < mca * mc; i += nthreads) carry[i] = T(0);
  __syncthreads();

  for (int l = 0; l < steps; ++l) {
    const bool active = act[l] > T(0.5);
    const T* p = panels + (int64_t)l * pe;
    for (int i = tid; i < pe; i += nthreads) {
      T val = p[i];
      if (i < mca * mc) val = val + carry[i];
      sh[i] = val;
    }
    __syncthreads();

    T* yl = y + (int64_t)l * pe;
    for (int j = 0; j < mc; ++j) {
      if (warp == 0) {
        T part = T(0);
        for (int r = j + 1 + lane; r < ma; r += 32) part = part + sh[r * mc + j] * sh[r * mc + j];
        const T sigma = warp_sum(part);
        const T x0 = sh[j * mc + j];
        const T norm = sqrt(x0 * x0 + sigma);
        const T beta = x0 >= T(0) ? -norm : norm;
        const bool degen = sigma <= T(0);
        const T denom = degen ? T(1) : x0 - beta;
        const T safe_beta = norm == T(0) ? T(1) : beta;
        const T t = degen ? T(0) : (beta - x0) / safe_beta;
        for (int r = lane; r < ma; r += 32) {
          const T vr = r == j ? T(1) : (r > j ? sh[r * mc + j] / denom : T(0));
          vv[r] = vr;
          yl[r * mc + j] = active ? vr : T(0);
        }
        if (lane == 0) {
          scal[0] = t;
          tau[(int64_t)l * mc + j] = active ? t : T(0);
        }
      }
      __syncthreads();
      const T t = scal[0];
      for (int c = j + warp; c < mc; c += nw) {
        T part = T(0);
        for (int r = j + lane; r < ma; r += 32) part = part + vv[r] * sh[r * mc + c];
        const T s = t * warp_sum(part);
        for (int r = j + lane; r < ma; r += 32) sh[r * mc + c] = sh[r * mc + c] - vv[r] * s;
      }
      __syncthreads();
    }

    T* vl = v + (int64_t)l * me * mc;
    for (int i = tid; i < me * mc; i += nthreads) {
      const int r = i / mc, c = i - (i / mc) * mc;
      const T val = (c >= r && r < ma) ? sh[r * mc + c] : T(0);
      vl[i] = active ? val : T(0);
    }
    if (active) {
      const int cix = l == 0 ? ci_first : ci;
      for (int i = tid; i < mca * mc; i += nthreads) {
        const int rr = i / mc + cix, cc = i - (i / mc) * mc + cix;
        carry[i] = (rr < ma && cc < mc && rr <= cc) ? sh[rr * mc + cc] : T(0);
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void banded_apply_w_kernel(const T* __restrict__ yf, const T* __restrict__ tauf,
                                      const T* __restrict__ w, const int32_t* __restrict__ ab,
                                      T* __restrict__ wq, int L, int ma, int mc, int mca, int ko,
                                      int h, int wrows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* W = reinterpret_cast<T*>(smem_raw);  // [wrows][ko] position-indexed work rows
  T* win = W + wrows * ko;                 // [ma][ko] this step's window
  T* ysh = win + ma * ko;                  // [ma][mc] this step's Y
  T* tsh = ysh + ma * mc;                  // [mc] this step's taus

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int c = tid;
  const int pe = ma * mc;
  const int we = ma * ko;

  for (int i = tid; i < wrows * ko; i += nthreads) W[i] = T(0);

  for (int l = 0; l < L; ++l) {
    __syncthreads();  // the previous step is done with ysh / tsh
    const int64_t step = (int64_t)s * L + l;
    for (int i = tid; i < pe; i += nthreads) ysh[i] = yf[step * pe + i];
    for (int i = tid; i < mc; i += nthreads) tsh[i] = tauf[step * mc + i];
    __syncthreads();
    if (c < ko) {
      const int a = ab[2 * l], b = ab[2 * l + 1];
      const int ac = a < h ? a : h, bc = b < h ? b : h;
      const T* wl = w + step * we;
      for (int r = 0; r < ma; ++r) {
        const int row = r < mca ? ac + r : bc + r - mca;
        win[r * ko + c] = W[row * ko + c] + wl[r * ko + c];
      }
      for (int j = 0; j < mc; ++j) {
        T acc = T(0);
        for (int r = j; r < ma; ++r) acc = acc + ysh[r * mc + j] * win[r * ko + c];
        acc = tsh[j] * acc;
        for (int r = j; r < ma; ++r) win[r * ko + c] = win[r * ko + c] - ysh[r * mc + j] * acc;
      }
      T* out = wq + step * we;
      for (int r = 0; r < ma; ++r) out[r * ko + c] = win[r * ko + c];
      // write back only positions below h: the pad rows [h, wrows) stay zero
      for (int r = 0; r < ma; ++r) {
        const bool head = r < mca;
        if ((head ? a + r : b + r - mca) < h) {
          const int row = head ? ac + r : bc + r - mca;
          W[row * ko + c] = win[r * ko + c];
        }
      }
    }
  }
}

int warps_for(int mc) { return mc < 1 ? 1 : (mc > kMaxWarps ? kMaxWarps : mc); }

template <typename T>
cudaError_t launch_chains(const T* panels, const T* act, T* y, T* tau, T* v, int64_t chains,
                          int64_t steps, int64_t ma, int64_t mc, int64_t mca, int64_t me,
                          int64_t ci, int64_t ci_first0, int64_t ci_first_rest,
                          cudaStream_t stream) {
  const size_t smem = (size_t)(ma * mc + mca * mc + ma + 1) * sizeof(T);
  banded_chain_kernel<T><<<(unsigned)chains, 32 * warps_for((int)mc), smem, stream>>>(
      panels, act, y, tau, v, (int)steps, (int)ma, (int)mc, (int)mca, (int)me, (int)ci,
      (int)ci_first0, (int)ci_first_rest);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_apply_w(const T* y, const T* tau, const T* w, const int32_t* ab, T* wq,
                           int64_t S, int64_t L, int64_t ma, int64_t mc, int64_t mca, int64_t ko,
                           int64_t h, int64_t wrows, cudaStream_t stream) {
  const size_t smem = (size_t)(wrows * ko + ma * ko + ma * mc + mc) * sizeof(T);
  const unsigned threads = (unsigned)(32 * ((ko + 31) / 32));
  banded_apply_w_kernel<T><<<(unsigned)S, threads, smem, stream>>>(
      y, tau, w, ab, wq, (int)L, (int)ma, (int)mc, (int)mca, (int)ko, (int)h, (int)wrows);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes (ops/banded.py).  Each launcher
// enqueues one kernel on the caller's stream, does not synchronize, and
// returns cudaGetLastError() (0 on success).  The caller allocates every
// buffer and checks the shared-memory size (<= 48 KB, no opt-in needed).
extern "C" {

// S chains of L steps; chain 0's first step cuts its carry at ci, the
// first step of chains >= 1 at ci0_rest (their dropped leading overlap).
int qrk_banded_segment_chains_f32(const float* panels, const float* act, float* y, float* tau,
                                  float* v, int64_t S, int64_t L, int64_t ma, int64_t mc,
                                  int64_t mca, int64_t me, int64_t ci, int64_t ci0_rest,
                                  cudaStream_t stream) {
  return (int)launch_chains<float>(panels, act, y, tau, v, S, L, ma, mc, mca, me, ci, ci,
                                   ci0_rest, stream);
}

int qrk_banded_segment_chains_f64(const double* panels, const double* act, double* y,
                                  double* tau, double* v, int64_t S, int64_t L, int64_t ma,
                                  int64_t mc, int64_t mca, int64_t me, int64_t ci,
                                  int64_t ci0_rest, cudaStream_t stream) {
  return (int)launch_chains<double>(panels, act, y, tau, v, S, L, ma, mc, mca, me, ci, ci,
                                    ci0_rest, stream);
}

// One chain of nb steps; its first step cuts the carry at ci0.
int qrk_banded_chain_qr_f32(const float* panels, const float* act, float* y, float* tau,
                            float* v, int64_t nb, int64_t ma, int64_t mc, int64_t mca,
                            int64_t me, int64_t ci, int64_t ci0, cudaStream_t stream) {
  return (int)launch_chains<float>(panels, act, y, tau, v, 1, nb, ma, mc, mca, me, ci, ci0, ci0,
                                   stream);
}

int qrk_banded_chain_qr_f64(const double* panels, const double* act, double* y, double* tau,
                            double* v, int64_t nb, int64_t ma, int64_t mc, int64_t mca,
                            int64_t me, int64_t ci, int64_t ci0, cudaStream_t stream) {
  return (int)launch_chains<double>(panels, act, y, tau, v, 1, nb, ma, mc, mca, me, ci, ci0, ci0,
                                    stream);
}

int qrk_banded_apply_w_f32(const float* y, const float* tau, const float* w, const int32_t* ab,
                           float* wq, int64_t S, int64_t L, int64_t ma, int64_t mc, int64_t mca,
                           int64_t ko, int64_t h, int64_t wrows, cudaStream_t stream) {
  return (int)launch_apply_w<float>(y, tau, w, ab, wq, S, L, ma, mc, mca, ko, h, wrows, stream);
}

int qrk_banded_apply_w_f64(const double* y, const double* tau, const double* w,
                           const int32_t* ab, double* wq, int64_t S, int64_t L, int64_t ma,
                           int64_t mc, int64_t mca, int64_t ko, int64_t h, int64_t wrows,
                           cudaStream_t stream) {
  return (int)launch_apply_w<double>(y, tau, w, ab, wq, S, L, ma, mc, mca, ko, h, wrows, stream);
}

const char* qrk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
