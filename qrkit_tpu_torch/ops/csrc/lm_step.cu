// The lane-major damped Gauss-Newton step (K3) for Hopper (sm_90a): the
// inner solve of the ellipse LM fit and of config 4's lane-major family.
//
// Replaces no Pallas kernel.  The reference runs the step as one jitted XLA
// program (qrkit_tpu/functional.py: lm_damped_step_blockdiag :319-417,
// _soa_tall_qr_solve :278-316, lm_damped_step_blockdiag1 :419-433), which
// XLA fuses into a few loops; op by op in PyTorch it is some 230 small
// launches.  It solves
//
//     min || [J; sqrt(lam) I] d + [r; 0] ||,   J = [blkdiag(left_i) | right]
//
// for nb points, each with a BL x BC block left_i, BL rows of the dense
// right block (M2 columns) and BL residuals, in three phases:
//
//   lm_local_kernel    (K3a) one thread a point: the damped point block
//                      [left_i; sqrt(lam) I_BC] (BR = BL + BC rows) and its
//                      [right_i | -res_i] rows in registers, BC unrolled
//                      Householder steps; writes the point's R1 (packed
//                      upper), r12 and y1 rows; its BL complement rows of
//                      [right | -res] (the bottom panel's lanes) stay in
//                      registers, and the CTA runs the lane-pivoted
//                      Householder QR of the skinny panel over its tile's
//                      lanes, writing one M2-lane partial [R | Q^T y].
//   lm_reduce_kernel   (K3b) the same QR over groups of stacked partials:
//                      a level of the reduction tree (many CTAs, one
//                      partial a group), or the finish (one CTA a problem):
//                      the partials, then the sqrt(lam) I_M2 tail lanes,
//                      then the M2 x M2 back-substitution, writing x2.
//   lm_backsub_kernel  (K3c) one thread a point: x1 = R1^-1 (y1 - r12 x2).
//
// Layout (lane-major, the point axis last and contiguous, as the reference
// keeps it): left [P, BL, BC, nb], right [P, BL, M2, nb], res [P, BL, nb],
// lam [P] over P independent problems (the vmapped batch fit; P = 1
// otherwise).  The factor rows fac [P, NF, nb]: per BC row j the packed R1
// row R1[j][j..BC-1], then per row j its r12[j][0..M2-1] and y1[j].  A
// partial stack [P, M2 + 1, lanes]: rows 0..M2-1 are the panel's columns
// (R transposed: lane l of row c holds R[l][c], l <= c, else 0), row M2 is
// Q^T y; partial t owns lanes t*M2 .. t*M2 + M2 - 1.  The output
// [P, stride]: x1 [BC, nb] then x2 [M2] (the flat step of the bc = 1 form
// written in place: no concatenation).
//
// The panel QR (tall_qr_cta) is the reference's recurrence: per column j
// the pivot lane j, the reflector of the lanes past it (beta =
// -sign(x0)||x||, one reciprocal c = 1/(beta (beta - x0)), c = 0 for a zero
// tail), w = c X u over the lanes and the rank-one update of the rows j..M2.
// Each thread holds K lanes (lane = k * blockDim.x + threadIdx.x; K = BL
// in K3a, a tile's point rows, K = kLanesPerThread in K3b), all rows in
// registers.  One step is one CTA reduction: the sums over the lanes past
// j of X_r * X_j for every row r >= j (row j's is sigma), plus the pivot
// lane's values, give w_r = c (s_r + X_r[j] (x0 - beta)) without a second
// pass.  A reduction is warp shuffles in a fixed butterfly, one value per
// warp in shared memory, and the warps added in order by every thread;
// the scratch is double-buffered, so a step has one __syncthreads.  No
// atomics: the same operands on the same grid give the same bits, and the
// grid follows the shapes alone.  Rows above j are not updated: their
// lanes past j lie below R's diagonal and are written as 0.
//
// The finish: one CTA holds at most kReduceThreads * kLanesPerThread lanes
// (the partials of `group` tiles and the M2 tail lanes), so a stack of more
// partials than that runs levels of the tree first (ops/lm_step.py plans
// them from the shapes: at 100k ellipse points, 391 tiles of 256 points,
// one finish; at 500k, 1954 tiles, one level of 5 CTAs, then the finish).
// A level reads its partials once from device memory (L2), where one CTA
// making M2 passes over a 500k stack would be bound by one SM's bandwidth.
//
// Bound: bytes.  At the ellipse's shape (BL 2, BC 1, M2 5, fp32) a point
// reads 56 bytes (left, right, res), K3a writes 28 bytes of factor rows
// that K3c reads back, and K3c writes 4: (56 + 2*28 + 4) B x 100k = 11.6 MB,
// 3.5 us at 3.35 TB/s (6.0 MB, 1.8 us, without the factor round trip).  The
// arithmetic is some 200 flops a point.  The design keeps every point's
// work in one thread's registers and reads each operand once, coalesced;
// the partial stack is 0.4% of the bytes.  What it does not remove is the
// launch count (3 at 100k, 4 at 500k) and K3a's M2 CTA-wide reductions.
//
// Numerics: true division and sqrt, and the build turns off FMA contraction
// (--fmad=false).  The point pass and K3c sum in the plain version's order;
// the panel's sums over lanes are trees, so the kernel agrees with the
// plain version (ops/lm_step.py) to rounding, not to the bit.
//
// Device: each launcher makes its operands' device current for the launch
// and the caller's device current again after it (DeviceGuard), then
// launches on the stream it is given; it returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -DQRK_BL=<rows> -DQRK_BC=<cols> -DQRK_M2=<right cols>
// (ops/_build.py does this at first use, one library per (BL, BC, M2)).

#include <cuda_runtime.h>
#include <cstdint>

#if !defined(QRK_BL) || !defined(QRK_BC) || !defined(QRK_M2)
#error "compile with -DQRK_BL=<block rows> -DQRK_BC=<block cols> -DQRK_M2=<right cols>"
#endif

namespace {

constexpr int kBL = QRK_BL, kBC = QRK_BC, kM2 = QRK_M2;
constexpr int kBR = kBL + kBC;                       // rows of a damped point block
constexpr int kR = kM2 + 1;                          // panel rows: the M2 columns, then y
constexpr int kNF = kBC * (kBC + 1) / 2 + kBC * kR;  // factor rows a point
constexpr int kTileMax = 256;                        // K3a: one thread a point
constexpr int kReduceThreads = 512;                  // K3b: at most
constexpr int kLanesPerThread = 4;                   // K3b: lanes a thread holds
constexpr int kSolveThreads = 256;                   // K3c
// ops/lm_step.py's TILE and REDUCE_LANES (a CTA's lanes in K3b) mirror these
static_assert(kTileMax == 256 && kReduceThreads * kLanesPerThread == 2048, "ops/lm_step.py");
static_assert(kBL >= 1 && kBC >= 1 && kM2 >= 1 && kM2 <= 16, "1 <= BL, 1 <= BC, 1 <= M2 <= 16");

// Makes `device` current for the guard's lifetime, then the caller's device
// again (see blockdiag_qr.cu).
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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// A panel QR's shared scratch, double-buffered by step: the per-warp sums
// and the pivot lane's values.
template <typename T, int MAXW>
struct Scratch {
  T red[2][MAXW][kR];
  T piv[2][kR];
};

// The lane-pivoted Householder QR of the CTA's panel, x[k][r] being row r
// of lane k * blockDim.x + threadIdx.x (zero lanes where nothing lies):
// M2 steps, in place.  blockDim.x is a multiple of 32, at most MAXW warps,
// and the CTA holds at least M2 lanes.
template <typename T, int K, int MAXW>
__device__ __forceinline__ void tall_qr_cta(T (&x)[K][kR], Scratch<T, MAXW>& s) {
  const int t = threadIdx.x, S = blockDim.x, warp = t >> 5, nw = S >> 5;
#pragma unroll
  for (int j = 0; j < kM2; ++j) {
    const int buf = j & 1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k * S + t == j) {
#pragma unroll
        for (int r = 0; r < kR; ++r) s.piv[buf][r] = x[k][r];
      }
    }
    T part[kR];
#pragma unroll
    for (int r = j; r < kR; ++r) part[r] = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k * S + t > j) {
        const T v = x[k][j];
#pragma unroll
        for (int r = j; r < kR; ++r) part[r] = part[r] + x[k][r] * v;
      }
    }
#pragma unroll
    for (int r = j; r < kR; ++r) {
      const T v = warp_sum(part[r]);
      if ((t & 31) == 0) s.red[buf][warp][r] = v;
    }
    __syncthreads();
    T tot[kR];
#pragma unroll
    for (int r = j; r < kR; ++r) {
      T v = T(0);
      for (int w = 0; w < nw; ++w) v = v + s.red[buf][w][r];
      tot[r] = v;
    }
    const T x0 = s.piv[buf][j];
    const T sigma = tot[j];
    const T norm = sqrt(x0 * x0 + sigma);
    const T beta = x0 >= T(0) ? -norm : norm;
    const bool degen = sigma <= T(0);
    const T c = degen ? T(0) : T(1) / (beta * (beta - x0));
    const T ud = x0 - beta;
    T w[kR];
#pragma unroll
    for (int r = j; r < kR; ++r) w[r] = c * (tot[r] + s.piv[buf][r] * ud);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int lane = k * S + t;
      const T u = lane == j ? ud : (lane > j ? x[k][j] : T(0));
#pragma unroll
      for (int r = j; r < kR; ++r) x[k][r] = x[k][r] - w[r] * u;
    }
  }
}

// The panel's leading M2 lanes as a partial: lane l of row c is R[l][c]
// (l <= c, else 0), row M2 is Q^T y; into out[r * ld + lane0 + l].
template <typename T, int K>
__device__ __forceinline__ void write_partial(const T (&x)[K][kR], T* __restrict__ out, int64_t ld,
                                              int64_t lane0) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int lane = k * blockDim.x + threadIdx.x;
    if (lane < kM2) {
#pragma unroll
      for (int r = 0; r < kR; ++r)
        out[(int64_t)r * ld + lane0 + lane] = (r == kM2 || lane <= r) ? x[k][r] : T(0);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileMax)
lm_local_kernel(const T* __restrict__ left, const T* __restrict__ right, const T* __restrict__ res,
                const T* __restrict__ lam, T* __restrict__ fac, T* __restrict__ stack, int64_t nb) {
  __shared__ Scratch<T, kTileMax / 32> scratch;
  const int64_t prob = blockIdx.y;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = p < nb;
  left += prob * kBL * kBC * nb;
  right += prob * kBL * kM2 * nb;
  res += prob * kBL * nb;
  fac += prob * kNF * nb;
  const T sl = sqrt(lam[prob]);

  // the damped point block a [BR][BC] and its rows of [right | -res]
  T a[kBR][kBC], B[kBR][kR];
#pragma unroll
  for (int i = 0; i < kBL; ++i) {
#pragma unroll
    for (int c = 0; c < kBC; ++c) a[i][c] = valid ? left[(int64_t)(i * kBC + c) * nb + p] : T(0);
#pragma unroll
    for (int c = 0; c < kM2; ++c) B[i][c] = valid ? right[(int64_t)(i * kM2 + c) * nb + p] : T(0);
    B[i][kM2] = valid ? -res[(int64_t)i * nb + p] : T(0);
  }
#pragma unroll
  for (int i = 0; i < kBC; ++i) {
#pragma unroll
    for (int c = 0; c < kBC; ++c) a[kBL + i][c] = i == c ? sl : T(0);
#pragma unroll
    for (int c = 0; c < kR; ++c) B[kBL + i][c] = T(0);
  }

  // BC Householder steps; column j itself is not updated, its diagonal
  // goes to R1 (beta, or x0 where the column is zero below it)
  T r1[kBC][kBC];
#pragma unroll
  for (int j = 0; j < kBC; ++j) {
    const T x0 = a[j][j];
    T sigma = T(0);
#pragma unroll
    for (int i = j + 1; i < kBR; ++i) sigma = sigma + a[i][j] * a[i][j];
    const T norm = sqrt(x0 * x0 + sigma);
    const T beta = x0 >= T(0) ? -norm : norm;
    const bool degen = sigma <= T(0);
    const T c = degen ? T(0) : T(1) / (beta * (beta - x0));
    T u[kBR];
    u[j] = x0 - beta;
#pragma unroll
    for (int i = j + 1; i < kBR; ++i) u[i] = a[i][j];
#pragma unroll
    for (int col = j + 1; col < kBC; ++col) {
      T w = T(0);
#pragma unroll
      for (int i = j; i < kBR; ++i) w = w + u[i] * a[i][col];
      w = c * w;
#pragma unroll
      for (int i = j; i < kBR; ++i) a[i][col] = a[i][col] - u[i] * w;
    }
#pragma unroll
    for (int col = 0; col < kR; ++col) {
      T w = T(0);
#pragma unroll
      for (int i = j; i < kBR; ++i) w = w + u[i] * B[i][col];
      w = c * w;
#pragma unroll
      for (int i = j; i < kBR; ++i) B[i][col] = B[i][col] - u[i] * w;
    }
    r1[j][j] = degen ? x0 : beta;
#pragma unroll
    for (int col = j + 1; col < kBC; ++col) r1[j][col] = a[j][col];
  }
  if (valid) {
    int e = 0;
#pragma unroll
    for (int j = 0; j < kBC; ++j)
#pragma unroll
      for (int col = j; col < kBC; ++col) fac[(int64_t)(e++) * nb + p] = r1[j][col];
#pragma unroll
    for (int j = 0; j < kBC; ++j)
#pragma unroll
      for (int col = 0; col < kR; ++col) fac[(int64_t)(e++) * nb + p] = B[j][col];
  }

  // the point's complement rows: lanes i * blockDim.x + threadIdx.x of the tile
  T x[kBL][kR];
#pragma unroll
  for (int i = 0; i < kBL; ++i)
#pragma unroll
    for (int r = 0; r < kR; ++r) x[i][r] = valid ? B[kBC + i][r] : T(0);
  tall_qr_cta<T, kBL, kTileMax / 32>(x, scratch);
  const int64_t ld = (int64_t)gridDim.x * kM2;
  write_partial<T, kBL>(x, stack + prob * kR * ld, ld, (int64_t)blockIdx.x * kM2);
}

// K3b over the stack in[P][R][lanes_in]: CTA g takes the lanes of partials
// g*group .. g*group + group - 1.  FINISH (one CTA a problem): the tail
// lanes sqrt(lam) I_M2 after them, the panel QR, the back-substitution of
// R x2 = (Q^T y)[:M2] into out[prob * out_stride ...]; otherwise the
// group's partial into out[P][R][gridDim.x * M2].
template <typename T, bool FINISH>
__global__ void __launch_bounds__(kReduceThreads)
lm_reduce_kernel(const T* __restrict__ in, int64_t lanes_in, const T* __restrict__ lam,
                 T* __restrict__ out, int64_t out_stride, int64_t group) {
  __shared__ Scratch<T, kReduceThreads / 32> scratch;
  __shared__ T rr[kR][kM2];
  const int64_t prob = blockIdx.y;
  const int64_t l0 = (int64_t)blockIdx.x * group * kM2;
  const int64_t rest = lanes_in - l0;
  const int64_t nl = rest < group * kM2 ? rest : group * kM2;
  in += prob * kR * lanes_in + l0;
  const T sl = FINISH ? sqrt(lam[prob]) : T(0);
  T x[kLanesPerThread][kR];
#pragma unroll
  for (int k = 0; k < kLanesPerThread; ++k) {
    const int64_t lane = (int64_t)k * blockDim.x + threadIdx.x;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      T v = T(0);
      if (lane < nl) {
        v = in[(int64_t)r * lanes_in + lane];
      } else if (FINISH && r < kM2 && lane - nl == r) {
        v = sl;  // tail lane r: sqrt(lam) in column r, 0 in y
      }
      x[k][r] = v;
    }
  }
  tall_qr_cta<T, kLanesPerThread, kReduceThreads / 32>(x, scratch);
  if constexpr (!FINISH) {
    const int64_t ld = (int64_t)gridDim.x * kM2;
    write_partial<T, kLanesPerThread>(x, out + prob * kR * ld, ld, (int64_t)blockIdx.x * kM2);
  } else {
#pragma unroll
    for (int k = 0; k < kLanesPerThread; ++k) {
      const int lane = k * blockDim.x + threadIdx.x;
      if (lane < kM2) {
#pragma unroll
        for (int r = 0; r < kR; ++r) rr[r][lane] = x[k][r];
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      // R[i][c] = rr[c][i] (c >= i), y = rr[M2]
      T x2[kM2];
#pragma unroll
      for (int i = kM2 - 1; i >= 0; --i) {
        T acc = rr[kM2][i];
#pragma unroll
        for (int c = i + 1; c < kM2; ++c) acc = acc - rr[c][i] * x2[c];
        x2[i] = acc / rr[i][i];
      }
#pragma unroll
      for (int i = 0; i < kM2; ++i) out[prob * out_stride + i] = x2[i];
    }
  }
}

// K3c: x1 = R1^-1 (y1 - r12 x2) a point, into out[prob * stride + j * nb + p].
template <typename T>
__global__ void __launch_bounds__(kSolveThreads)
lm_backsub_kernel(const T* __restrict__ fac, const T* __restrict__ x2, T* __restrict__ out,
                  int64_t nb, int64_t stride) {
  const int64_t prob = blockIdx.y;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= nb) return;
  fac += prob * kNF * nb;
  x2 += prob * stride;
  out += prob * stride;
  T xr[kM2];
#pragma unroll
  for (int c = 0; c < kM2; ++c) xr[c] = x2[c];
  T r1[kBC][kBC];
  int e = 0;
#pragma unroll
  for (int j = 0; j < kBC; ++j)
#pragma unroll
    for (int col = j; col < kBC; ++col) r1[j][col] = fac[(int64_t)(e++) * nb + p];
  T rhs[kBC];
#pragma unroll
  for (int j = 0; j < kBC; ++j) {
    T s = T(0);
#pragma unroll
    for (int c = 0; c < kM2; ++c) s = s + fac[(int64_t)(e + c) * nb + p] * xr[c];
    rhs[j] = fac[(int64_t)(e + kM2) * nb + p] - s;
    e += kR;
  }
  T x1[kBC];
#pragma unroll
  for (int j = kBC - 1; j >= 0; --j) {
    T acc = rhs[j];
#pragma unroll
    for (int col = j + 1; col < kBC; ++col) acc = acc - r1[j][col] * x1[col];
    x1[j] = acc / r1[j][j];
  }
#pragma unroll
  for (int j = 0; j < kBC; ++j) out[(int64_t)j * nb + p] = x1[j];
}

unsigned whole_warps(int64_t threads) { return (unsigned)((threads + 31) / 32 * 32); }

template <typename T>
cudaError_t launch_local(const T* left, const T* right, const T* res, const T* lam, T* fac,
                         T* stack, int64_t nb, int64_t nprob, int64_t tile, cudaStream_t stream) {
  if (tile < 32 || tile > kTileMax || tile % 32 || tile * kBL < kM2 || nprob < 1 || nprob > 65535 ||
      nb < 0)
    return cudaErrorInvalidValue;
  const int64_t tiles = nb > 0 ? (nb + tile - 1) / tile : 1;
  lm_local_kernel<T><<<dim3((unsigned)tiles, (unsigned)nprob), (unsigned)tile, 0, stream>>>(
      left, right, res, lam, fac, stack, nb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reduce(const T* in, int64_t lanes_in, const T* lam, T* out, int64_t out_stride,
                          int64_t group, int64_t nprob, int finish, cudaStream_t stream) {
  const int64_t parts = lanes_in / kM2;
  if (lanes_in < kM2 || lanes_in % kM2 || group < (finish ? 1 : 2) || nprob < 1 ||
      nprob > 65535 || (finish && parts > group))
    return cudaErrorInvalidValue;
  const int64_t lanes = (parts < group ? parts : group) * kM2 + (finish ? kM2 : 0);
  const int64_t threads = (lanes + kLanesPerThread - 1) / kLanesPerThread;
  if (threads > kReduceThreads) return cudaErrorInvalidValue;
  const unsigned block = whole_warps(threads);
  if (finish) {
    lm_reduce_kernel<T, true><<<dim3(1, (unsigned)nprob), block, 0, stream>>>(
        in, lanes_in, lam, out, out_stride, group);
  } else {
    const int64_t groups = (parts + group - 1) / group;
    lm_reduce_kernel<T, false><<<dim3((unsigned)groups, (unsigned)nprob), block, 0, stream>>>(
        in, lanes_in, lam, out, out_stride, group);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backsub(const T* fac, const T* x2, T* out, int64_t nb, int64_t nprob,
                           int64_t stride, cudaStream_t stream) {
  if (nb < 1 || nprob < 1 || nprob > 65535) return cudaErrorInvalidValue;
  const int64_t ctas = (nb + kSolveThreads - 1) / kSolveThreads;
  lm_backsub_kernel<T><<<dim3((unsigned)ctas, (unsigned)nprob), kSolveThreads, 0, stream>>>(
      fac, x2, out, nb, stride);
  return cudaGetLastError();
}

template <typename F>
int launch_on(int device, F&& enqueue) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  return (int)enqueue();
}

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py).  Each launcher makes
// `device` current, enqueues one kernel on the caller's stream of that
// device, makes the caller's device current again, does not synchronize,
// and returns cudaGetLastError() (cudaErrorInvalidValue, without a launch,
// for a geometry it does not take).  The caller allocates every buffer.
//   qrk_lm_local    K3a: fac [P, NF, nb], stack [P, M2 + 1, tiles * M2],
//                   tiles = ceil(nb / tile) (1 when nb = 0); tile a
//                   multiple of 32 in [32, 256] with tile * BL >= M2.
//   qrk_lm_reduce   K3b: a level (finish = 0) into out [P, M2 + 1,
//                   ceil(parts / group) * M2], or the finish (finish = 1,
//                   parts <= group) writing x2 to out + prob * out_stride;
//                   at most 2048 lanes a CTA.
//   qrk_lm_backsub  K3c: x1 into out + prob * stride, reading x2 at
//                   x2 + prob * stride.
extern "C" {

#define QRK_LM_LAUNCHERS(SUF, T)                                                                  \
  int qrk_lm_local_##SUF(int device, const T* left, const T* right, const T* res, const T* lam,   \
                         T* fac, T* stack, int64_t nb, int64_t nprob, int64_t tile,               \
                         cudaStream_t stream) {                                                   \
    return launch_on(device, [&] {                                                                \
      return launch_local<T>(left, right, res, lam, fac, stack, nb, nprob, tile, stream);         \
    });                                                                                           \
  }                                                                                               \
  int qrk_lm_reduce_##SUF(int device, const T* in, int64_t lanes_in, const T* lam, T* out,        \
                          int64_t out_stride, int64_t group, int64_t nprob, int finish,           \
                          cudaStream_t stream) {                                                  \
    return launch_on(device, [&] {                                                                \
      return launch_reduce<T>(in, lanes_in, lam, out, out_stride, group, nprob, finish, stream);  \
    });                                                                                           \
  }                                                                                               \
  int qrk_lm_backsub_##SUF(int device, const T* fac, const T* x2, T* out, int64_t nb,             \
                           int64_t nprob, int64_t stride, cudaStream_t stream) {                  \
    return launch_on(device,                                                                      \
                     [&] { return launch_backsub<T>(fac, x2, out, nb, nprob, stride, stream); }); \
  }

QRK_LM_LAUNCHERS(f32, float)
QRK_LM_LAUNCHERS(f64, double)

#undef QRK_LM_LAUNCHERS

const char* qrk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
