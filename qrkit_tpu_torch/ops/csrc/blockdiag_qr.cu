// Batched tiny-block Householder QR for Hopper (sm_90a): fused least-squares
// solve and packed-R factorization of a block-diagonal system.
//
// Replaces the Pallas TPU kernels in qrkit_tpu/ops/pallas_blockdiag.py:
//   blockdiag_lstsq_kernel  <- _lstsq_kernel (:154-226), SoA form with the
//                              b_scale and stepnorm options (no b_delta)
//   stepnorm_finish_kernel  <- the stepnorm accumulation across grid steps
//                              (the TPU kernel's SMEM scalar, :213-224)
//   blockdiag_qr_r_kernel   <- _qr_r_kernel (:443-453)
//   householder_inplace     <- _householder_inplace (:108-151), the shared
//                              unrolled recurrence
//
// Layout (SoA, block index contiguous): entry (r, c) of block k sits at
// a[(r*BC + c)*n + k], rhs row r at b[r*n + k], x row j at x[j*n + k], packed
// R entry e = (j, c >= j) in row-major order at r_out[e*n + k].
//
// Mapping: one thread per block; the ragged edge is masked with k < n (no
// padding blocks).  Neighbouring threads read neighbouring addresses, so
// every row e of the operand is one coalesced stream.  The whole block and
// its rhs live in registers; BR and BC are compile-time constants (one
// library per shape), so every loop below unrolls fully, as the TPU kernel's
// did at trace time.
//
// Grid: the CTA size is chosen by n alone at launch (grid_for): the largest
// of 256, 128, 64 and 32 threads that still makes kMinCtas CTAs, half of the
// H100's 132 SMs.  The solvers' main paths launch small batches (10,000
// blocks of 7x2 for config 2, 5,000 of 19x3 for the bundle's point blocks,
// under 1.3 MB), where 256-thread CTAs filled only 40 and 20 SMs, each SM
// queueing 8 warps of loads; they now run 79 CTAs of 128 and 79 of 64.  More,
// smaller CTAs cost more to launch than they save.  1M blocks still run CTAs
// of 256.  The sweep that measured this (CTA sizes, and several threads
// ("lanes") per block with shuffle reductions, and sums as balanced trees,
// both slower at every shape the solvers launch; PERF.md §6) is
// profile_blockdiag.py's `sweep` at commits c5f28c7 and 9ec7e69; the
// recurrence stays one thread's, summed left to right.  The grid does not
// depend on the card, so the stepnorm sum's bits depend on n alone.
//
// Bound: device-memory bandwidth at large n.  A 7x2 fp32 block moves
// (14 + 7 + 2)*4 = 92 bytes for roughly 100 flops (about 1 flop/byte, against
// the H100's ~20 fp32 flops/byte), so the kernels do no more than read each
// input once and write each output once.  At the main paths' small batches
// the time is the launch (the empty kernel on the same grid) plus one
// thread's loads and dependent chain.
//
// Options (template flags, so the plain instantiation is the code it was):
//   SCALED    x is multiplied by *scale, a device scalar read by every thread
//             (never a host float: no host sync); by linearity that is the
//             solution for scale * b.  Applied after the back substitution,
//             as the TPU kernel does.
//   STEPNORM  sum of x^2 over every block: each thread sums its block's
//             (scaled) x_j^2, the CTA reduces them (warp shuffles, then one
//             value per warp in shared memory) into partials[blockIdx.x],
//             and stepnorm_finish_kernel adds the partials in a fixed order
//             (no atomics: the same inputs on the same grid give the same
//             bits).  Threads past the ragged edge contribute exactly 0.
//
// Numerics: true division and sqrt (no --use_fast_math), and the build turns
// off FMA contraction (--fmad=false) so every multiply and add rounds on its
// own, exactly as the op-by-op plain PyTorch version in ops/blockdiag.py
// does.  The kernel then agrees with the plain version to the bit, even on
// ill-conditioned blocks where one ulp in R is amplified by cond(A) in x.
//
// Device: each launcher makes its operands' device current for the launch
// and makes the caller's device current again after it (DeviceGuard), then
// launches on the stream it is given.
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

constexpr int kMaxThreads = 256;
constexpr int kMinThreads = 32;
constexpr int64_t kMinCtas = 66;  // half of the H100's 132 SMs
// ops/blockdiag.py sizes the stepnorm partials, one per CTA, as ceil(n / 32)
static_assert(kMinThreads == 32, "the stepnorm partials buffer holds ceil(n / 32) values");

// Makes `device` current for the guard's lifetime, then the caller's device
// again.  This library's CUDA runtime (linked statically) and PyTorch's both
// follow the thread's current CUDA context, so a switch left in place would
// move PyTorch's current device too.  Costs one cudaGetDevice when `device`
// is current already.
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

struct Grid {
  unsigned ctas, threads;
};

// One thread per block, in CTAs of the largest of 256, 128, 64, 32 threads
// that still makes kMinCtas CTAs (32 when even that cannot).
Grid grid_for(int64_t n) {
  int64_t t = kMaxThreads;
  while (t > kMinThreads && (n + t - 1) / t < kMinCtas) t >>= 1;
  return {(unsigned)((n + t - 1) / t), (unsigned)t};
}

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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// The sum of v over the CTA (blockDim.x a multiple of 32, at most
// kMaxThreads): warp shuffles, one value per warp in shared memory, then
// warp 0 adds those.  Thread 0 holds the result.
template <typename T>
__device__ __forceinline__ T cta_sum(T v) {
  __shared__ T warp_part[kMaxThreads / 32];
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < (blockDim.x >> 5) ? warp_part[threadIdx.x] : T(0);
    v = warp_sum(v);
  }
  return v;
}

template <typename T, int BR, int BC, bool SCALED = false, bool STEPNORM = false>
__global__ void __launch_bounds__(kMaxThreads)
blockdiag_lstsq_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ x,
                       int64_t n, const T* __restrict__ scale = nullptr,
                       T* __restrict__ partials = nullptr) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (!STEPNORM) {
    if (k >= n) return;
  }
  T sq = T(0);  // this block's sum of x_j^2 (STEPNORM only)
  if (k < n) {
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
    if constexpr (SCALED) {
      const T s = *scale;
#pragma unroll
      for (int j = 0; j < BC; ++j) xs[j] = xs[j] * s;
    }
#pragma unroll
    for (int j = 0; j < BC; ++j) x[(int64_t)j * n + k] = xs[j];
    if constexpr (STEPNORM) {
#pragma unroll
      for (int j = 0; j < BC; ++j) sq = sq + xs[j] * xs[j];
    }
  }
  if constexpr (STEPNORM) {
    sq = cta_sum(sq);
    if (threadIdx.x == 0) partials[blockIdx.x] = sq;
  }
}

// One CTA adds the per-CTA partials of the step norm: thread t sums
// partials t, t + kMaxThreads, ... in order, then the CTA reduces as above.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
stepnorm_finish_kernel(const T* __restrict__ partials, int64_t nparts, T* __restrict__ out) {
  T v = T(0);
  for (int64_t i = threadIdx.x; i < nparts; i += kMaxThreads) v = v + partials[i];
  v = cta_sum(v);
  if (threadIdx.x == 0) *out = v;
}

template <typename T, int BR, int BC>
__global__ void __launch_bounds__(kMaxThreads)
blockdiag_qr_r_kernel(const T* __restrict__ a, T* __restrict__ r_out, int64_t n) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
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

// The launch floor of B1/B2: a kernel that does nothing, on their grid.
// Its device time is what a launch of that grid costs before any byte
// moves; it computes nothing and no path of the solvers calls it
// (chip_smoke.py times it).
__global__ void __launch_bounds__(kMaxThreads) empty_kernel() {}

// Make the device current, pick the grid for n, enqueue, restore the
// caller's device; returns cudaGetLastError().
template <typename F>
int launch_on(int device, int64_t n, F&& enqueue) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  return (int)enqueue(grid_for(n));
}

template <typename T>
cudaError_t launch_lstsq(const T* a, const T* b, T* x, int64_t n, Grid gr, cudaStream_t stream) {
  blockdiag_lstsq_kernel<T, QRK_BR, QRK_BC><<<gr.ctas, gr.threads, 0, stream>>>(a, b, x, n);
  return cudaGetLastError();
}

// The options: scale may be null (no b_scale); partials and sn_out are both
// null (no stepnorm) or both set, partials holding one value per CTA (at
// most ceil(n / 32)).
template <typename T>
cudaError_t launch_lstsq_opt(const T* a, const T* b, T* x, const T* scale, T* partials,
                             T* sn_out, int64_t n, Grid gr, cudaStream_t stream) {
  const bool scaled = scale != nullptr, stepnorm = partials != nullptr;
  if (scaled && stepnorm) {
    blockdiag_lstsq_kernel<T, QRK_BR, QRK_BC, true, true>
        <<<gr.ctas, gr.threads, 0, stream>>>(a, b, x, n, scale, partials);
  } else if (scaled) {
    blockdiag_lstsq_kernel<T, QRK_BR, QRK_BC, true, false>
        <<<gr.ctas, gr.threads, 0, stream>>>(a, b, x, n, scale, nullptr);
  } else if (stepnorm) {
    blockdiag_lstsq_kernel<T, QRK_BR, QRK_BC, false, true>
        <<<gr.ctas, gr.threads, 0, stream>>>(a, b, x, n, nullptr, partials);
  } else {
    blockdiag_lstsq_kernel<T, QRK_BR, QRK_BC><<<gr.ctas, gr.threads, 0, stream>>>(a, b, x, n);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !stepnorm) return err;
  stepnorm_finish_kernel<T><<<1, kMaxThreads, 0, stream>>>(partials, (int64_t)gr.ctas, sn_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_qr_r(const T* a, T* r_out, int64_t n, Grid gr, cudaStream_t stream) {
  blockdiag_qr_r_kernel<T, QRK_BR, QRK_BC><<<gr.ctas, gr.threads, 0, stream>>>(a, r_out, n);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py).  Each launcher makes
// `device` (its operands' CUDA ordinal) current, enqueues one kernel on the
// caller's stream of that device (the lstsq_opt launcher with stepnorm a
// second, the finish kernel), makes the caller's device current again, does
// not synchronize, and returns cudaGetLastError() (0 on success).  n >= 1;
// the caller allocates every buffer.
extern "C" {

int qrk_blockdiag_lstsq_f32(int device, const float* a, const float* b, float* x, int64_t n,
                            cudaStream_t stream) {
  return launch_on(device, n,
                   [&](Grid gr) { return launch_lstsq<float>(a, b, x, n, gr, stream); });
}

int qrk_blockdiag_lstsq_f64(int device, const double* a, const double* b, double* x, int64_t n,
                            cudaStream_t stream) {
  return launch_on(device, n,
                   [&](Grid gr) { return launch_lstsq<double>(a, b, x, n, gr, stream); });
}

int qrk_blockdiag_lstsq_opt_f32(int device, const float* a, const float* b, float* x,
                                const float* scale, float* partials, float* sn_out, int64_t n,
                                cudaStream_t stream) {
  return launch_on(device, n, [&](Grid gr) {
    return launch_lstsq_opt<float>(a, b, x, scale, partials, sn_out, n, gr, stream);
  });
}

int qrk_blockdiag_lstsq_opt_f64(int device, const double* a, const double* b, double* x,
                                const double* scale, double* partials, double* sn_out, int64_t n,
                                cudaStream_t stream) {
  return launch_on(device, n, [&](Grid gr) {
    return launch_lstsq_opt<double>(a, b, x, scale, partials, sn_out, n, gr, stream);
  });
}

int qrk_blockdiag_qr_r_f32(int device, const float* a, float* r_out, int64_t n,
                           cudaStream_t stream) {
  return launch_on(device, n,
                   [&](Grid gr) { return launch_qr_r<float>(a, r_out, n, gr, stream); });
}

int qrk_blockdiag_qr_r_f64(int device, const double* a, double* r_out, int64_t n,
                           cudaStream_t stream) {
  return launch_on(device, n,
                   [&](Grid gr) { return launch_qr_r<double>(a, r_out, n, gr, stream); });
}

int qrk_blockdiag_empty(int device, int64_t n, cudaStream_t stream) {
  return launch_on(device, n, [&](Grid gr) {
    empty_kernel<<<gr.ctas, gr.threads, 0, stream>>>();
    return cudaGetLastError();
  });
}

const char* qrk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
