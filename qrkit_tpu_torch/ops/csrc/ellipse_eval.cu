// The ellipse model's residuals, Jacobian and gradient (K4) for Hopper
// (sm_90a): the elementwise passes of the ellipse LM fit's iteration.
//
// Replaces no Pallas kernel.  The reference computes the model as jnp
// expressions inside jax.jit (qrkit_tpu/examples/ellipse.py: _residuals
// :65, _residuals_soa :134, _jacobian_soa :147, and the gradient's
// jax.vjp in qrkit_tpu/lm.py), which XLA fuses into a few loops; op by op
// in PyTorch it is some 155 small kernels an LM iteration.  Here one pass
// over the points evaluates it, one thread a point (a lane), over a grid of
// nprob * tiles CTAs of kThreads threads (tiles = ceil(n / kThreads), at
// least 1), P independent problems side by side (the vmapped batch fit):
//
//   K4r  residuals_kernel   r [P, 2n], interleaved: r[2i] = X_i - x(t_i),
//                           r[2i + 1] = Y_i - y(t_i).
//   K4j  jacobian_kernel    the lane-major operands of the damped step:
//                           left [P, 2, n] (d r / d t_i), right [P, 2, 5, n]
//                           (d r / d (a, b, x0, y0, r)) and res [P, 2, n].
//   K4g  vjp_kernel         g = J^T rbar [P, n + 5]: lane i writes g[i] =
//                           left[:, i] . rbar_i; the five parameter entries
//                           are sums over the lanes: a butterfly of warp
//                           shuffles, the CTA's warps in order, one partial
//                           a CTA, and the problem's last CTA to take its
//                           ticket (atomic, acq_rel) sums the partials in
//                           index order.  The order of the sums never
//                           depends on the order of arrival: two calls give
//                           the same bits.
//
// Layout: params [P, n + 5] (t_0..t_{n-1}, then a, b, x0, y0, r) with row
// stride params_ld; pts [P, 2, n] with problem stride pts_ld and row stride
// pts_row (a rank's slice of a wider point array is read in place); the
// point axis is contiguous in both.  Outputs are contiguous.
//
// Bound: bytes.  At 500,000 points in fp32, K4j reads 12 B and writes 56 B
// a point (34 MB, 10 us at 3.35 TB/s), K4r reads 12 B and writes 8 B, K4g
// reads 12 B and writes 4 B.  The arithmetic is a few dozen flops and one
// sin and cos a point.
//
// Numerics: each output is the torch formula it replaces (ops/ellipse_eval.py,
// the plain versions), evaluated in the same order with each product and
// sum rounded on its own (the build turns off FMA contraction:
// --fmad=false) and the precise sin / cos (cosf / sinf in fp32, never
// __cosf), so the elementwise outputs equal PyTorch's bit for bit.  Only
// K4g's five sums run in another order than torch.sum's.
//
// Device: each launcher makes its operands' device current for the launch
// and the caller's device current again after it (DeviceGuard), then
// launches on the stream it is given; it returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC   (ops/_build.py, one library for every shape)

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // points a CTA; ops/ellipse_eval.py's THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kModel = 5;      // a, b, x0, y0, r

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

__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

__device__ __forceinline__ unsigned atomic_add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// the butterfly: every lane ends with the same bits (a + b == b + a)
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// The model at point t of a problem whose parameters are q[0..n+4].
template <typename T>
struct Model {
  T ct, st, cr, sr, a, b, x0, y0;
};

template <typename T>
__device__ __forceinline__ Model<T> model(const T* __restrict__ q, int64_t n, T t) {
  Model<T> m;
  m.ct = cos_(t);
  m.st = sin_(t);
  m.a = q[n];
  m.b = q[n + 1];
  m.x0 = q[n + 2];
  m.y0 = q[n + 3];
  m.cr = cos_(q[n + 4]);
  m.sr = sin_(q[n + 4]);
  return m;
}

// x(t) and y(t): x = a ct cr - b st sr + x0, y = a ct sr + b st cr + y0
template <typename T>
__device__ __forceinline__ void position(const Model<T>& m, T& x, T& y) {
  x = m.a * m.ct * m.cr - m.b * m.st * m.sr + m.x0;
  y = m.a * m.ct * m.sr + m.b * m.st * m.cr + m.y0;
}

// d r / d t (left) and the two rows of d r / d (a, b, x0, y0, r) (right)
template <typename T>
__device__ __forceinline__ void jacobian(const Model<T>& m, T left[2], T row0[kModel], T row1[kModel]) {
  left[0] = m.a * m.cr * m.st + m.b * m.sr * m.ct;
  left[1] = m.a * m.sr * m.st - m.b * m.cr * m.ct;
  row0[0] = -m.ct * m.cr;
  row0[1] = m.st * m.sr;
  row0[2] = T(-1);
  row0[3] = T(0);
  row0[4] = m.a * m.ct * m.sr + m.b * m.st * m.cr;
  row1[0] = -m.ct * m.sr;
  row1[1] = -m.st * m.cr;
  row1[2] = T(0);
  row1[3] = T(-1);
  row1[4] = -m.a * m.ct * m.cr + m.b * m.st * m.sr;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    residuals_kernel(const T* __restrict__ params, int64_t params_ld, const T* __restrict__ pts,
                     int64_t pts_ld, int64_t pts_row, T* __restrict__ r, int64_t n, int64_t tiles) {
  const int64_t prob = blockIdx.x / tiles;
  const int64_t i = (blockIdx.x % tiles) * kThreads + threadIdx.x;
  if (i >= n) return;
  const T* q = params + prob * params_ld;
  const T* p = pts + prob * pts_ld;
  const Model<T> m = model(q, n, q[i]);
  T x, y;
  position(m, x, y);
  typename Vec2<T>::type v;
  v.x = p[i] - x;
  v.y = p[pts_row + i] - y;
  reinterpret_cast<typename Vec2<T>::type*>(r + prob * 2 * n)[i] = v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    jacobian_kernel(const T* __restrict__ params, int64_t params_ld, const T* __restrict__ pts,
                    int64_t pts_ld, int64_t pts_row, T* __restrict__ left, T* __restrict__ right,
                    T* __restrict__ res, int64_t n, int64_t tiles) {
  const int64_t prob = blockIdx.x / tiles;
  const int64_t i = (blockIdx.x % tiles) * kThreads + threadIdx.x;
  if (i >= n) return;
  const T* q = params + prob * params_ld;
  const T* p = pts + prob * pts_ld;
  const Model<T> m = model(q, n, q[i]);
  T l[2], row0[kModel], row1[kModel], x, y;
  jacobian(m, l, row0, row1);
  position(m, x, y);
  T* lp = left + prob * 2 * n;
  lp[i] = l[0];
  lp[n + i] = l[1];
  T* rp = right + prob * 2 * kModel * n;
#pragma unroll
  for (int k = 0; k < kModel; ++k) {
    rp[k * n + i] = row0[k];
    rp[(kModel + k) * n + i] = row1[k];
  }
  T* sp = res + prob * 2 * n;
  sp[i] = p[i] - x;
  sp[n + i] = p[pts_row + i] - y;
}

// The CTA's sum of each thread's c[0..4]: each warp's butterfly, then the
// warps in order by thread 0, whose c holds the result.  Every thread of
// the CTA calls it.
template <typename T>
__device__ __forceinline__ void cta_sum(T c[kModel], T (*smem)[kModel]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < kModel; ++k) {
    const T s = warp_sum(c[k]);
    if (lane == 0) smem[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kModel; ++k) {
      T s = smem[0][k];
      for (int w = 1; w < kWarps; ++w) s = s + smem[w][k];
      c[k] = s;
    }
  }
  __syncthreads();  // smem is written again by the next call
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    vjp_kernel(const T* __restrict__ params, int64_t params_ld, const T* __restrict__ rbar,
               T* __restrict__ g, T* __restrict__ partials, unsigned* __restrict__ ticket, int64_t n,
               int64_t tiles) {
  __shared__ T smem[kWarps][kModel];
  __shared__ bool last;
  const int64_t prob = blockIdx.x / tiles;
  const int64_t tile = blockIdx.x % tiles;
  const int64_t i = tile * kThreads + threadIdx.x;
  const T* q = params + prob * params_ld;
  T* gp = g + prob * (n + kModel);
  T c[kModel];
#pragma unroll
  for (int k = 0; k < kModel; ++k) c[k] = T(0);
  if (i < n) {
    const Model<T> m = model(q, n, q[i]);
    T l[2], row0[kModel], row1[kModel];
    jacobian(m, l, row0, row1);
    const typename Vec2<T>::type rb = reinterpret_cast<const typename Vec2<T>::type*>(rbar + prob * 2 * n)[i];
    gp[i] = l[0] * rb.x + l[1] * rb.y;
#pragma unroll
    for (int k = 0; k < kModel; ++k) c[k] = row0[k] * rb.x + row1[k] * rb.y;
  }
  cta_sum(c, smem);
  T* part = partials + prob * tiles * kModel;
  if (threadIdx.x == 0) {  // the ticket releases the partial and acquires the others'
#pragma unroll
    for (int k = 0; k < kModel; ++k) part[tile * kModel + k] = c[k];
    last = atomic_add_acq_rel(ticket + prob, 1u) == (unsigned)(tiles - 1);
  }
  __syncthreads();
  if (!last) return;
  // the problem's last CTA: thread t sums partials t, t + kThreads, ... in
  // order, then the CTA sum
#pragma unroll
  for (int k = 0; k < kModel; ++k) c[k] = T(0);
  for (int64_t j = threadIdx.x; j < tiles; j += kThreads) {
#pragma unroll
    for (int k = 0; k < kModel; ++k) c[k] = c[k] + __ldcg(part + j * kModel + k);
  }
  cta_sum(c, smem);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kModel; ++k) gp[n + k] = c[k];
  }
}

int64_t tiles_of(int64_t n) { return n > kThreads ? (n + kThreads - 1) / kThreads : 1; }

bool grid_ok(int64_t n, int64_t nprob) {
  return n >= 0 && nprob >= 1 && nprob * tiles_of(n) <= 0x7fffffffLL;
}

template <typename F>
int launch_on(int device, F&& enqueue) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  return (int)enqueue();
}

template <typename T>
cudaError_t launch_residuals(const T* params, int64_t params_ld, const T* pts, int64_t pts_ld,
                             int64_t pts_row, T* r, int64_t n, int64_t nprob, cudaStream_t stream) {
  if (!grid_ok(n, nprob)) return cudaErrorInvalidValue;
  const int64_t tiles = tiles_of(n);
  residuals_kernel<T><<<(unsigned)(nprob * tiles), kThreads, 0, stream>>>(params, params_ld, pts, pts_ld,
                                                                          pts_row, r, n, tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_jacobian(const T* params, int64_t params_ld, const T* pts, int64_t pts_ld,
                            int64_t pts_row, T* left, T* right, T* res, int64_t n, int64_t nprob,
                            cudaStream_t stream) {
  if (!grid_ok(n, nprob)) return cudaErrorInvalidValue;
  const int64_t tiles = tiles_of(n);
  jacobian_kernel<T><<<(unsigned)(nprob * tiles), kThreads, 0, stream>>>(params, params_ld, pts, pts_ld,
                                                                         pts_row, left, right, res, n, tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vjp(const T* params, int64_t params_ld, const T* rbar, T* g, T* partials,
                       unsigned* ticket, int64_t n, int64_t nprob, cudaStream_t stream) {
  if (!grid_ok(n, nprob)) return cudaErrorInvalidValue;
  const int64_t tiles = tiles_of(n);
  cudaError_t err = cudaMemsetAsync(ticket, 0, (size_t)nprob * sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  vjp_kernel<T><<<(unsigned)(nprob * tiles), kThreads, 0, stream>>>(params, params_ld, rbar, g, partials,
                                                                    ticket, n, tiles);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py).  Each launcher makes
// `device` current, enqueues on the caller's stream of that device, makes
// the caller's device current again, does not synchronize, and returns
// cudaGetLastError() (cudaErrorInvalidValue, without a launch, for a grid it
// does not take).  The caller allocates every buffer.
//   qrk_ellipse_residuals  K4r: r [nprob, 2n].
//   qrk_ellipse_jacobian   K4j: left [nprob, 2, n], right [nprob, 2, 5, n],
//                          res [nprob, 2, n].
//   qrk_ellipse_vjp        K4g: one memset of ticket [nprob] (uint32), then
//                          the launch: g [nprob, n + 5] from rbar [nprob,
//                          2n]; partials [nprob, tiles, 5], tiles =
//                          max(1, ceil(n / 256)).
extern "C" {

#define QRK_ELLIPSE_LAUNCHERS(SUF, T)                                                                 \
  int qrk_ellipse_residuals_##SUF(int device, const T* params, int64_t params_ld, const T* pts,       \
                                  int64_t pts_ld, int64_t pts_row, T* r, int64_t n, int64_t nprob,    \
                                  cudaStream_t stream) {                                              \
    return launch_on(device, [&] {                                                                    \
      return launch_residuals<T>(params, params_ld, pts, pts_ld, pts_row, r, n, nprob, stream);       \
    });                                                                                               \
  }                                                                                                   \
  int qrk_ellipse_jacobian_##SUF(int device, const T* params, int64_t params_ld, const T* pts,        \
                                 int64_t pts_ld, int64_t pts_row, T* left, T* right, T* res,          \
                                 int64_t n, int64_t nprob, cudaStream_t stream) {                     \
    return launch_on(device, [&] {                                                                    \
      return launch_jacobian<T>(params, params_ld, pts, pts_ld, pts_row, left, right, res, n, nprob,  \
                                stream);                                                              \
    });                                                                                               \
  }                                                                                                   \
  int qrk_ellipse_vjp_##SUF(int device, const T* params, int64_t params_ld, const T* rbar, T* g,      \
                            T* partials, unsigned* ticket, int64_t n, int64_t nprob,                  \
                            cudaStream_t stream) {                                                    \
    return launch_on(device, [&] {                                                                    \
      return launch_vjp<T>(params, params_ld, rbar, g, partials, ticket, n, nprob, stream);           \
    });                                                                                               \
  }

QRK_ELLIPSE_LAUNCHERS(f32, float)
QRK_ELLIPSE_LAUNCHERS(f64, double)

#undef QRK_ELLIPSE_LAUNCHERS

const char* qrk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
