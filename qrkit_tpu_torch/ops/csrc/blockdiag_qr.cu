// Batched tiny-block Householder QR for Hopper (sm_90a): fused least-squares
// solve and packed-R factorization of a block-diagonal system.
//
// Replaces the Pallas TPU kernels in qrkit_tpu/ops/pallas_blockdiag.py:
//   blockdiag_lstsq_kernel  <- _lstsq_kernel (:154-226), SoA form without the
//                              b_scale / stepnorm / b_delta options
//   blockdiag_qr_r_kernel   <- _qr_r_kernel (:443-453)
//   householder_inplace     <- _householder_inplace (:108-151), the shared
//                              unrolled recurrence
//
// Layout (SoA, block index contiguous): entry (r, c) of block k sits at
// a[(r*BC + c)*n + k], rhs row r at b[r*n + k], x row j at x[j*n + k], packed
// R entry e = (j, c >= j) in row-major order at r_out[e*n + k].
//
// Mapping: one thread per block, 256 threads per CUDA block, grid
// ceil(n/256); the ragged edge is masked with k < n (no padding blocks).
// Neighbouring threads read neighbouring addresses, so every row e of the
// operand is one coalesced stream.  The whole block and its rhs live in
// registers; BR and BC are compile-time constants (one library per shape),
// so every loop below unrolls fully, as the TPU kernel's did at trace time.
//
// Bound: device-memory bandwidth.  A 7x2 fp32 block moves (14 + 7 + 2)*4 =
// 92 bytes for roughly 100 flops (about 1 flop/byte, against the H100's
// ~20 fp32 flops/byte), so the kernels do no more than read each input once
// and write each output once.  Wider loads and several blocks per thread
// are later work.
//
// Numerics: true division and sqrt (no --use_fast_math), and the build turns
// off FMA contraction (--fmad=false) so every multiply and add rounds on its
// own, exactly as the op-by-op plain PyTorch version in ops/blockdiag.py
// does.  The kernel then agrees with the plain version to the bit, even on
// ill-conditioned blocks where one ulp in R is amplified by cond(A) in x.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -DQRK_BR=<rows> -DQRK_BC=<cols>
// (ops/_build.py does this at first use, one library per block shape).

#include <cuda_runtime.h>
#include <cstdint>

#if !defined(QRK_BR) || !defined(QRK_BC)
#error "compile with -DQRK_BR=<block rows> -DQRK_BC=<block cols>"
#endif

static_assert(QRK_BC >= 1 && QRK_BR >= QRK_BC, "portrait blocks only (br >= bc >= 1)");
static_assert(QRK_BR * QRK_BC <= 64, "the register-resident recurrence is for br*bc <= 64");

namespace {

constexpr int kThreads = 256;

// Unrolled Householder QR of a[BR][BC] in place, in the unnormalized
// reflector form H = I - u u^T / (beta (beta - x0)) with u = (x0 - beta,
// a[j+1..][j]): one reciprocal per column.  Column j itself is never
// updated; only its diagonal survives into R, written directly as beta (or
// x0 when the column is already zero below the diagonal).  With WITH_RHS,
// H is applied to rhs as well, so rhs ends as Q^T b.
template <typename T, int BR, int BC, bool WITH_RHS>
__device__ __forceinline__ void householder_inplace(T (&a)[BR][BC], T (&rhs)[BR]) {
#pragma unroll
  for (int j = 0; j < BC; ++j) {
    const T x0 = a[j][j];
    T sigma = T(0);
#pragma unroll
    for (int r = j + 1; r < BR; ++r) sigma = sigma + a[r][j] * a[r][j];
    const T norm = sqrt(x0 * x0 + sigma);
    const T beta = x0 >= T(0) ? -norm : norm;
    const bool degen = sigma <= T(0);
    // u^T u = 2 beta (beta - x0); H = I - u u^T * c, c = 1 / (beta (beta - x0))
    const T t = beta * (beta - x0);
    const T c = degen ? T(0) : T(1) / t;
    T u[BR];
    u[j] = x0 - beta;
#pragma unroll
    for (int r = j + 1; r < BR; ++r) u[r] = a[r][j];
    a[j][j] = degen ? x0 : beta;
#pragma unroll
    for (int col = j + 1; col < BC; ++col) {
      T w = u[j] * a[j][col];
#pragma unroll
      for (int r = j + 1; r < BR; ++r) w = w + u[r] * a[r][col];
      w = c * w;
#pragma unroll
      for (int r = j; r < BR; ++r) a[r][col] = a[r][col] - u[r] * w;
    }
    if constexpr (WITH_RHS) {
      T w = u[j] * rhs[j];
#pragma unroll
      for (int r = j + 1; r < BR; ++r) w = w + u[r] * rhs[r];
      w = c * w;
#pragma unroll
      for (int r = j; r < BR; ++r) rhs[r] = rhs[r] - u[r] * w;
    }
  }
}

template <typename T, int BR, int BC>
__device__ __forceinline__ void load_block(const T* __restrict__ a, int64_t n, int64_t k,
                                           T (&m)[BR][BC]) {
#pragma unroll
  for (int r = 0; r < BR; ++r)
#pragma unroll
    for (int c = 0; c < BC; ++c) m[r][c] = a[(int64_t)(r * BC + c) * n + k];
}

template <typename T, int BR, int BC>
__global__ void __launch_bounds__(kThreads)
blockdiag_lstsq_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ x,
                       int64_t n) {
  const int64_t k = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  T m[BR][BC];
  T rhs[BR];
  load_block<T, BR, BC>(a, n, k, m);
#pragma unroll
  for (int r = 0; r < BR; ++r) rhs[r] = b[(int64_t)r * n + k];
  householder_inplace<T, BR, BC, true>(m, rhs);
  // back substitution on the BC x BC upper triangle
  T xs[BC];
#pragma unroll
  for (int j = BC - 1; j >= 0; --j) {
    T acc = rhs[j];
#pragma unroll
    for (int c = j + 1; c < BC; ++c) acc = acc - m[j][c] * xs[c];
    xs[j] = acc / m[j][j];
  }
#pragma unroll
  for (int j = 0; j < BC; ++j) x[(int64_t)j * n + k] = xs[j];
}

template <typename T, int BR, int BC>
__global__ void __launch_bounds__(kThreads)
blockdiag_qr_r_kernel(const T* __restrict__ a, T* __restrict__ r_out, int64_t n) {
  const int64_t k = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  T m[BR][BC];
  T unused[BR];
  load_block<T, BR, BC>(a, n, k, m);
  householder_inplace<T, BR, BC, false>(m, unused);
  int e = 0;
#pragma unroll
  for (int j = 0; j < BC; ++j)
#pragma unroll
    for (int c = j; c < BC; ++c) r_out[(int64_t)(e++) * n + k] = m[j][c];
}

template <typename T>
cudaError_t launch_lstsq(const T* a, const T* b, T* x, int64_t n, cudaStream_t stream) {
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  blockdiag_lstsq_kernel<T, QRK_BR, QRK_BC><<<grid, kThreads, 0, stream>>>(a, b, x, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_qr_r(const T* a, T* r_out, int64_t n, cudaStream_t stream) {
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  blockdiag_qr_r_kernel<T, QRK_BR, QRK_BC><<<grid, kThreads, 0, stream>>>(a, r_out, n);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes (ops/blockdiag.py).  Each launcher
// enqueues one kernel on the caller's stream, does not synchronize, and
// returns cudaGetLastError() (0 on success).  n >= 1; the caller allocates
// every buffer.
extern "C" {

int qrk_blockdiag_lstsq_f32(const float* a, const float* b, float* x, int64_t n,
                            cudaStream_t stream) {
  return (int)launch_lstsq<float>(a, b, x, n, stream);
}

int qrk_blockdiag_lstsq_f64(const double* a, const double* b, double* x, int64_t n,
                            cudaStream_t stream) {
  return (int)launch_lstsq<double>(a, b, x, n, stream);
}

int qrk_blockdiag_qr_r_f32(const float* a, float* r_out, int64_t n, cudaStream_t stream) {
  return (int)launch_qr_r<float>(a, r_out, n, stream);
}

int qrk_blockdiag_qr_r_f64(const double* a, double* r_out, int64_t n, cudaStream_t stream) {
  return (int)launch_qr_r<double>(a, r_out, n, stream);
}

const char* qrk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
