// The R-only tall-skinny QR of the ragged block-angular step's bottom (K5)
// for Hopper (sm_90a): R2 [n, n] and y2 = (Q2^T rhs)[:n] of a = [J2 | rhs]
// [m, n + 1], m >> n, by Householder reflections, keeping nothing else.
//
// Replaces no Pallas kernel.  The ragged step exists only in the port
// (functional.block_angular_lstsq_ragged); the dense step's TSQR
// (parallel/tsqr.py, cuSOLVER's geqrf, the compact-WY T factors and Q^T on
// the rhs) keeps Q for its other callers.  The ragged step needs R2 and y2
// alone, so nothing of Q leaves this kernel: no reflector, no T factor is
// written to device memory.
//
// Bound: operations.  At BAL Venice-52's bottom (694,814 x 468 and the rhs,
// fp32) the QR and Q^T on the rhs take 3.06e11 operations (4.56 ms at 67
// TFLOP/s outside the tensor cores); the bottom's 1.30 GB read once is 0.39
// ms at 3.35 TB/s.  fp32 FFMA only: no TF32 in any form (the configuration
// says "fp32, no TF32"), no normal equations, no Cholesky QR.
//
// Design: panel CAQR keeping R (Anderson, Ballard, Demmel, Keutzer,
// "Communication-Avoiding QR Decomposition for GPUs", IPDPS 2011).  The n
// columns go in panels of kB = 32 (the last one narrower); the rhs is always
// a trailing column.  A panel is 1 + L launches of one kernel (level_kernel),
// L = the levels of a tree of fan-in kG = kH / kB over the tiles:
//
//   leaf (level 0)   a CTA a tile of kH = 256 rows.  It stages the tile's
//                    panel in shared memory, factors it in registers (the
//                    reflector convention of ops/householder.py:
//                    beta = -sign(x0)|x|, tau = (beta - x0) / beta, tau = 0 on
//                    a zero tail; v scaled by 1 / (x0 - beta)), keeps V and
//                    the compact-WY T in shared memory, writes the tile's R
//                    (kB x kB) to scratch, and streams the tile's trailing
//                    columns through shared memory in chunks of kC = 32:
//                    W = V^T C, W2 = T^T W, C - V W2 written back in place.
//   level l >= 1     a CTA a group of kG representatives of level l - 1: a
//                    virtual tile of kG x kB rows, the panel from their R
//                    blocks (scratch), the trailing columns from their top
//                    kB rows in place; the same device code.  Its R goes to
//                    the other scratch buffer.
//   last level       one group: its R and its top rows' trailing columns are
//                    the panel's rows of R2 (and of y2 at the rhs), written
//                    out; those rows are zeroed in the working matrix.
//
// The working matrix is the caller's bottom, factored in place (it is the
// step's own temporary).  Rows of a tile below its top kB are done with the
// panel's columns after the leaf and wait, updated, for the next panel; the
// tree mixes the tiles' top rows only.  A level with fewer groups than the
// card holds CTAs splits each group's trailing chunks over blockIdx.y: every
// CTA of a group factors the same panel (the same bits), the first writes
// its R.
//
// The panel's factorization: thread (warp w, lane) holds rows 8 lane ..
// 8 lane + 7 of columns 4 w .. 4 w + 3 in registers.  A column step: the
// column's warp sums its squares below the diagonal (a warp butterfly),
// forms beta, tau and v and publishes v; one barrier; each warp then forms
// v^T P for its four columns (eight rows a lane, a butterfly of four sums)
// and updates them.  The step is latency-bound (about 1,800 cycles, most of
// it the butterflies, the square root and the two divisions); the other CTA
// on the SM streams its chunks meanwhile.
//
// The trailing update: W = V^T C (kB x kC over kH rows: four row slices of
// 64, a 4 x 4 register tile a thread, summed in a fixed order) and C - V W2
// (an 8 x 4 register tile a thread over kB), from shared memory laid out
// with a 4-word XOR swizzle so that both read patterns are free of bank
// conflicts; a warp loads and stores 32 rows of a chunk a lane a column
// (coalesced), the next chunk's loads in flight during this one's work.  2
// CTAs an SM (94 KB of shared memory each in fp32).  At kB = 32 the
// trailing matrix moves about 19 GB an iteration of BAL; the chunks take
// most of the time, bound by that traffic and the latency between the
// barriers rather than by the FFMAs (4.56 ms).
//
// Numerics: sums in a fixed order (warp butterflies, then the CTA's warps or
// slices in index order), no atomics: two calls give the same bits.  The
// products' accumulations use fma() explicitly (the build's --fmad=false
// forbids only contraction); the reflector's scalars are the reference's
// formulas, each rounded on its own; R's diagonal is beta itself.
//
// Device: the launcher makes its operands' device current for the launches
// and the caller's device current again after them (DeviceGuard), then
// enqueues on the stream it is given; it returns cudaGetLastError().  Every
// grid follows from (m, n) and the SM count, with no host synchronization,
// so a call captures into a CUDA graph (the LM loop's WHILE body).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC   (ops/_build.py, one library for every shape)

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>
#include <utility>

namespace {

constexpr int kB = 32;                 // panel width; ops/tall_qr.py's PANEL
constexpr int kH = 256;                // rows a tile; ops/tall_qr.py's TILE
constexpr int kC = 32;                 // trailing columns a chunk
constexpr int kG = kH / kB;            // fan-in of a tree level
constexpr int kThreads = kH;           // a warp a slice of 32 rows when loading and storing
constexpr int kWarps = kThreads / 32;
constexpr int kPc = kH + 4;            // the staged panel's column stride (16-byte rows)
constexpr int kSlices = kThreads / 64; // row slices of W = V^T X
constexpr int kCtasPerSm = 2;  // __launch_bounds__'s minimum: 94 KB of shared memory each (fp32)

static_assert(kB == 32 && kC == 32, "the swizzle and the thread tiles assume 32-wide panels and chunks");
static_assert(kH == kG * kB && kThreads == 256 && kWarps * 4 == kB,
              "the thread tiles assume 256 rows and threads, a warp 4 of the panel's columns");

// shared memory, in elements: the staged panel (factor phase) or a chunk and
// W's partials (update phase), then V, T, W, W2, tau, v (two buffers)
constexpr int kRegion = (kB * kPc > kH * kC + kSlices * kB * kC) ? kB * kPc : kH * kC + kSlices * kB * kC;
constexpr int kOffV = kRegion;
constexpr int kOffT = kOffV + kH * kB;
constexpr int kOffW = kOffT + kB * kB;
constexpr int kOffW2 = kOffW + kB * kC;
constexpr int kOffTau = kOffW2 + kB * kC;
constexpr int kOffVcol = kOffTau + kB;
constexpr int kSmemElems = kOffVcol + 2 * kH;

template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)kSmemElems * sizeof(T);
}

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

// element (r, c) of a [rows][32] array: the 4-word group c / 4 XOR-ed with
// (r / 8) mod 8, so that 4 rows 8 apart read one column group from 4 banks
__device__ __forceinline__ int sw(int r, int c) {
  return r * 32 + ((((c >> 2) ^ (r >> 3)) & 7) << 2) + (c & 3);
}

__device__ __forceinline__ void ld4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void ld4(const double* p, double (&o)[4]) {
  const double2 u = *reinterpret_cast<const double2*>(p), v = *reinterpret_cast<const double2*>(p + 2);
  o[0] = u.x, o[1] = u.y, o[2] = v.x, o[3] = v.y;
}
__device__ __forceinline__ void st4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void st4(double* p, const double (&o)[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(o[0], o[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(o[2], o[3]);
}

template <typename T>
__device__ __forceinline__ void ld8(const T* p, T (&o)[8]) {
  T a[4], b[4];
  ld4(p, a);
  ld4(p + 4, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = a[i], o[i + 4] = b[i];
}
template <typename T>
__device__ __forceinline__ void st8(T* p, const T (&o)[8]) {
  const T a[4] = {o[0], o[1], o[2], o[3]}, b[4] = {o[4], o[5], o[6], o[7]};
  st4(p, a);
  st4(p + 4, b);
}

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }

// the butterfly: every lane ends with the same bits (a + b == b + a)
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// f(std::integral_constant<int, i>) for i = 0 .. N - 1, each i a constant:
// arrays in registers are indexed by it (a loop that the compiler leaves
// rolled would put them in local memory)
template <int... I, class F>
__device__ __forceinline__ void each_index(std::integer_sequence<int, I...>, F&& f) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, class F>
__device__ __forceinline__ void unrolled(F&& f) {
  each_index(std::make_integer_sequence<int, N>{}, f);
}

template <typename T>
struct Level {
  T* a;              // the working matrix [m, ncols], row stride lda
  int64_t lda, m, n; // n = R2's order; ncols = n + 1 (the rhs last)
  int64_t p0;        // the panel's first column
  int pw;            // its width (<= kB)
  int leaf;          // 1: a CTA a tile of a; 0: a group of representatives
  int final_;        // one group: R2 and y2 out, their rows zeroed in a
  int64_t members;   // level >= 1: the previous level's representatives
  int64_t stride;    // level >= 1: the tile stride between them
  const T* s_in;     // level >= 1: their R blocks [members, kB, kB]
  T* s_out;          // this level's R blocks [groups, kB, kB] (not final_)
  int64_t chunks;    // trailing chunks of the panel
  int64_t per_split; // chunks a CTA of blockIdx.y
  T* r2;             // [n, n]
  T* y2;             // [n]
};

// The virtual tile's rows come in kG slices of kB = 32 consecutive rows of
// a: a leaf's slice ws is its tile's rows 32 ws .., a tree level's the top
// rows of member q kG + ws of the previous level.  Returns how many of the
// slice's rows exist (0..32) and its first row in *row0.
template <typename T>
__device__ __forceinline__ int slice_rows(const Level<T>& L, int64_t q, int ws, int64_t* row0) {
  int64_t r0;
  if (L.leaf) {
    r0 = q * kH + ws * kB;
  } else {
    const int64_t i = q * kG + ws;
    if (i >= L.members) return 0;
    r0 = i * L.stride * kH;
  }
  *row0 = r0;
  const int64_t left = L.m - r0;
  return left <= 0 ? 0 : (left < kB ? (int)left : kB);
}

// out [kB][kC] = Vs^T X over the kH rows (X a swizzled [kH][kC] array): a
// thread a 4 x 4 tile of one row slice, the slices' partials summed in
// order.  Every thread of the CTA calls it (two barriers inside).
template <typename T>
__device__ __forceinline__ void vt_times(const T* Vs, const T* X, T* Wp, T* out, int t, int vcols) {
  const int s = t >> 6, tile = t & 63, ti = tile >> 3, tc = tile & 7;
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
  if (4 * ti < vcols) {  // V's columns past the panel's width are zero
#pragma unroll 4
    for (int rr = 0; rr < kH / kSlices; ++rr) {
      const int r = s * (kH / kSlices) + rr;
      T v[4], x[4];
      ld4(Vs + sw(r, 4 * ti), v);
      ld4(X + sw(r, 4 * tc), x);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma_(v[i], x[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) st4(Wp + (s * kB + 4 * ti + i) * kC + 4 * tc, acc[i]);
  __syncthreads();
  for (int e = t; e < kB * kC; e += kThreads) {
    T sum = Wp[e];
#pragma unroll
    for (int q = 1; q < kSlices; ++q) sum = sum + Wp[q * kB * kC + e];
    out[e] = sum;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) level_kernel(const Level<T> L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* Pc = sm;                   // [kB][kPc], the panel by columns (factor phase)
  T* X = sm;                    // [kH][kC] swizzled, a chunk (after the panel)
  T* Wp = sm + kH * kC;         // [kSlices][kB][kC]
  T* Vs = sm + kOffV;           // [kH][kB] swizzled
  T* Tm = sm + kOffT;           // [kB][kB], T of I - V T V^T
  T* W = sm + kOffW;            // [kB][kC]; first the Gram V^T V
  T* W2 = sm + kOffW2;          // [kB][kC]
  T* tau_s = sm + kOffTau;
  T* vcol = sm + kOffVcol;      // [2][kH]: column j's v, by the parity of j

  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int64_t q = blockIdx.x;
  const int pw = L.pw;
  const int64_t ncols = L.n + 1;

  // the panel: a's columns [p0, p0 + pw) of the tile's rows, or the members'
  // R blocks, staged by columns; V's and tau's columns past pw zero.  Warp w
  // loads slice w, a lane a column.
  int64_t wrow0 = 0;
  const int wrows = slice_rows(L, q, w, &wrow0);
  {
    const int64_t member = q * kG + w;
    const bool has_block = !L.leaf && member < L.members;
#pragma unroll 4
    for (int it = 0; it < kB; ++it) {
      T val = T(0);
      if (lane < pw) {
        if (L.leaf) {
          if (it < wrows) val = L.a[(wrow0 + it) * L.lda + L.p0 + lane];
        } else if (has_block) {
          val = L.s_in[(member * kB + it) * kB + lane];
        }
      }
      Pc[lane * kPc + w * kB + it] = val;
      Vs[sw(w * kB + it, lane)] = T(0);
    }
  }
  if (t < kB) tau_s[t] = T(0);
  __syncthreads();

  // the panel's Householder QR in registers: thread (w, lane) holds rows
  // r0 .. r0 + 7 (r0 = 8 lane) of columns 4 w .. 4 w + 3.  A column step: its
  // warp takes the column's norm below the diagonal (a warp sum), writes v
  // and tau; one barrier; then each warp forms v^T P for its columns (eight
  // rows a lane, a warp sum) and updates them.
  const int r0 = 8 * lane;
  T p[8][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    T c8[8];
    ld8(Pc + (4 * w + u) * kPc + r0, c8);
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k][u] = c8[k];
  }
  for (int j = 0; j < pw; ++j) {
    const int ou = j & 3;
    T* vc = vcol + (j & 1) * kH;
    if (w == (j >> 2)) {  // the column's warp
      T xc[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) xc[k] = ou == 0 ? p[k][0] : ou == 1 ? p[k][1] : ou == 2 ? p[k][2] : p[k][3];
      T sq[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) sq[k] = r0 + k > j ? xc[k] * xc[k] : T(0);
      const T sigma = warp_sum(((sq[0] + sq[1]) + (sq[2] + sq[3])) + ((sq[4] + sq[5]) + (sq[6] + sq[7])));
      T x0l = xc[0];
#pragma unroll
      for (int k = 1; k < 8; ++k) x0l = (j & 7) == k ? xc[k] : x0l;
      const T x0 = __shfl_sync(0xffffffffu, x0l, j >> 3);
      const T norm = sqrt_(x0 * x0 + sigma);
      const T beta = x0 >= T(0) ? -norm : norm;
      const bool degenerate = sigma <= T(0);
      const T denom = degenerate ? T(1) : x0 - beta;
      const T tau = degenerate ? T(0) : (beta - x0) / (norm == T(0) ? T(1) : beta);
      const T scale = T(1) / denom;  // v = x / (x0 - beta) below the diagonal, as LAPACK scales it
      T v8[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v8[k] = r0 + k > j ? xc[k] * scale : (r0 + k == j ? T(1) : T(0));
        Vs[sw(r0 + k, j)] = v8[k];
      }
      st8(vc + r0, v8);
      if (lane == 0) tau_s[j] = tau;
      const T diag = degenerate ? x0 : beta;  // R's diagonal
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (u == ou && r0 + k == j) p[k][u] = diag;
    }
    __syncthreads();  // column j's v and tau
    if (4 * w + 3 > j) {
      T vr[8];
      ld8(vc + r0, vr);
      const T tau = tau_s[j];
      T d[4];  // v^T P[:, c] over the lane's rows, then the warp's (the same bits in every lane)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        T a0 = T(0), a1 = T(0);
#pragma unroll
        for (int k = 0; k < 4; ++k) a0 = fma_(vr[k], p[k][u], a0), a1 = fma_(vr[k + 4], p[k + 4][u], a1);
        d[u] = a0 + a1;
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1)
#pragma unroll
        for (int u = 0; u < 4; ++u) d[u] = d[u] + __shfl_xor_sync(0xffffffffu, d[u], m);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const T wv = tau * d[u];
#pragma unroll
        for (int k = 0; k < 8; ++k) p[k][u] = 4 * w + u > j ? p[k][u] - vr[k] * wv : p[k][u];
      }
    }
  }

  // R (rows 0..pw-1, lanes 0..3): the first CTA of the group writes it
  if (blockIdx.y == 0) {
    if (lane < 4) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = r0 + k, c = 4 * w + u;
          const T val = (r < pw && c < pw && c >= r) ? p[k][u] : T(0);
          if (!L.final_)
            L.s_out[(q * kB + r) * kB + c] = val;
          else if (r < pw && c < pw)
            L.r2[(L.p0 + r) * L.n + L.p0 + c] = val;
        }
    }
    if (L.final_)
      for (int64_t e = t; e < (int64_t)pw * L.p0; e += kThreads)
        L.r2[(L.p0 + e / L.p0) * L.n + e % L.p0] = T(0);
  }
  __syncthreads();  // the staged panel's region becomes the chunk's; V complete

  // T: the Gram V^T V, then T's columns by the reference's recurrence
  // (ops/householder.py build_t_factor, here un-negated), a lane a row
  vt_times(Vs, Vs, Wp, W, t, pw);
  if (w == 0) {
    T row[kB];
    unrolled<kB>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < j; ++k) acc = fma_(row[k], W[k * kC + j], acc);
      const T tj = tau_s[j];
      row[j] = lane < j ? -(tj * acc) : (lane == j ? tj : T(0));
    });
#pragma unroll
    for (int j = 0; j < kB; ++j) Tm[lane * kB + j] = row[j];
  }
  __syncthreads();

  // the trailing columns, a chunk at a time: C <- C - V (T^T (V^T C))
  const int64_t first = blockIdx.y * L.per_split;
  const int64_t last = first + L.per_split < L.chunks ? first + L.per_split : L.chunks;
  const int rg = t >> 3, tc = t & 7;  // the update's tile: rows 8 rg .., columns 4 tc ..
  // warp w loads slice w of a chunk, a lane a column, into registers: the
  // next chunk's loads are in flight while this one is worked on
  T buf[kB];
  const auto load = [&](int64_t ch) {
    const int64_t col0 = L.p0 + pw + ch * kC;
    const T* src = L.a + wrow0 * L.lda + col0 + lane;
    const bool col_ok = col0 + lane < ncols;
#pragma unroll
    for (int it = 0; it < kB; ++it) buf[it] = (col_ok && it < wrows) ? src[it * L.lda] : T(0);
  };
  if (first < last) load(first);
  for (int64_t ch = first; ch < last; ++ch) {
    const int64_t col0 = L.p0 + pw + ch * kC;
    const int cw = (int)(ncols - col0 < kC ? ncols - col0 : kC);
#pragma unroll
    for (int it = 0; it < kB; ++it) X[sw(w * kB + it, lane)] = buf[it];
    if (ch + 1 < last) load(ch + 1);
    __syncthreads();
    vt_times(Vs, X, Wp, W, t, pw);
    {  // W2 = T^T W: a thread 4 columns of one row j
      const int j = t >> 3, c0 = 4 * (t & 7);
      T o[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        if (i > j) continue;
        const T tij = Tm[i * kB + j];
        T wi[4];
        ld4(W + i * kC + c0, wi);
#pragma unroll
        for (int b = 0; b < 4; ++b) o[b] = fma_(tij, wi[b], o[b]);
      }
      st4(W2 + j * kC + c0, o);
    }
    __syncthreads();
    {  // C - V W2: a thread rows 8 rg .. 8 rg + 7, columns 4 tc .. 4 tc + 3
      T prod[8][4];
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int b = 0; b < 4; ++b) prod[k][b] = T(0);
      for (int i = 0; i < pw; i += 4) {
        T w2[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) ld4(W2 + (i + u) * kC + 4 * tc, w2[u]);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          T v[4];
          ld4(Vs + sw(8 * rg + k, i), v);
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int b = 0; b < 4; ++b) prod[k][b] = fma_(v[u], w2[u][b], prod[k][b]);
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = sw(8 * rg + k, 4 * tc + b);
          X[i] = X[i] - prod[k][b];
        }
    }
    __syncthreads();
    {  // warp w stores slice w back, a lane a column; the last level's top pw
       // rows go to R2 and y2 and leave zeros
      T* dst = L.a + wrow0 * L.lda + col0 + lane;
      const bool col_ok = lane < cw;
      const bool out = L.final_ && w == 0;
#pragma unroll 8
      for (int it = 0; it < kB; ++it) {
        const T val = X[sw(w * kB + it, lane)];
        if (!col_ok) continue;
        if (out && it < pw) {
          if (col0 + lane < L.n)
            L.r2[(L.p0 + it) * L.n + col0 + lane] = val;
          else
            L.y2[L.p0 + it] = val;
          if (it < wrows) dst[it * L.lda] = T(0);
        } else if (it < wrows) {
          dst[it * L.lda] = val;
        }
      }
    }
    __syncthreads();  // X and W2 are the next chunk's
  }
}

struct Plan {
  int64_t tiles, levels, panels, launches, scratch_blocks;
};

Plan plan_of(int64_t m, int64_t n) {
  Plan p;
  p.tiles = m > 0 ? (m + kH - 1) / kH : 1;
  p.levels = 0;
  for (int64_t c = p.tiles; c > 1; c = (c + kG - 1) / kG) ++p.levels;
  p.panels = (n + kB - 1) / kB;
  p.launches = p.panels * (1 + p.levels);
  p.scratch_blocks = p.tiles + (p.tiles + kG - 1) / kG;
  return p;
}

template <typename F>
int launch_on(int device, F&& enqueue) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  return (int)enqueue();
}

template <typename T>
cudaError_t launch_tall_qr(T* a, int64_t lda, int64_t m, int64_t n, T* r2, T* y2, T* scratch,
                           int64_t scratch_blocks, cudaStream_t stream) {
  const Plan p = plan_of(m, n);
  if (n < 1 || m < 0 || lda < n + 1 || scratch_blocks < p.scratch_blocks || p.tiles > INT32_MAX)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(level_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  const int64_t resident = (int64_t)kCtasPerSm * (sms > 0 ? sms : 1);
  T* s[2] = {scratch, scratch + p.tiles * kB * kB};
  Level<T> L{};
  L.a = a, L.lda = lda, L.m = m, L.n = n, L.r2 = r2, L.y2 = y2;
  for (int64_t panel = 0; panel < p.panels; ++panel) {
    L.p0 = panel * kB;
    L.pw = (int)(n - L.p0 < kB ? n - L.p0 : kB);
    L.chunks = (n + 1 - L.p0 - L.pw + kC - 1) / kC;
    int64_t members = p.tiles, stride = 1;
    for (int64_t level = 0; level <= p.levels; ++level) {
      const int64_t groups = level == 0 ? p.tiles : (members + kG - 1) / kG;
      L.leaf = level == 0;
      L.final_ = level == p.levels;
      L.members = members, L.stride = stride;
      L.s_in = level == 0 ? nullptr : s[(level - 1) & 1];
      L.s_out = s[level & 1];
      // split a group's chunks over blockIdx.y until the level fills the card
      int64_t splits = (resident + groups - 1) / groups;
      splits = splits < 1 ? 1 : (splits > L.chunks ? L.chunks : splits);
      L.per_split = (L.chunks + splits - 1) / splits;
      splits = (L.chunks + L.per_split - 1) / L.per_split;
      level_kernel<T><<<dim3((unsigned)groups, (unsigned)splits), kThreads, smem, stream>>>(L);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      if (level >= 1) stride *= kG;
      members = groups;
    }
  }
  return cudaSuccess;
}

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py).
//   qrk_tall_qr_<f32|f64>  K5: R2 [n, n] and y2 [n] (row-major, contiguous)
//                          of a [m, n + 1] (row stride lda, columns
//                          contiguous, overwritten); scratch holds
//                          scratch_blocks blocks of 32 x 32 (the plan's
//                          tiles + ceil(tiles / 8)).  Makes `device`
//                          current, enqueues the plan's launches on
//                          `stream`, does not synchronize, and returns
//                          cudaGetLastError() (cudaErrorInvalidValue,
//                          without a launch, for operands it does not take).
//   qrk_tall_qr_plan       out[5] = tiles, levels, panels, launches,
//                          scratch blocks of (m, n).
extern "C" {

#define QRK_TALL_QR_LAUNCHER(SUF, T)                                                                   \
  int qrk_tall_qr_##SUF(int device, T* a, int64_t lda, int64_t m, int64_t n, T* r2, T* y2, T* scratch, \
                        int64_t scratch_blocks, cudaStream_t stream) {                                 \
    return launch_on(device, [&] {                                                                     \
      return launch_tall_qr<T>(a, lda, m, n, r2, y2, scratch, scratch_blocks, stream);                \
    });                                                                                                \
  }

QRK_TALL_QR_LAUNCHER(f32, float)
QRK_TALL_QR_LAUNCHER(f64, double)

#undef QRK_TALL_QR_LAUNCHER

int qrk_tall_qr_plan(int64_t m, int64_t n, int64_t* out) {
  const Plan p = plan_of(m, n);
  out[0] = p.tiles, out[1] = p.levels, out[2] = p.panels, out[3] = p.launches, out[4] = p.scratch_blocks;
  return 0;
}

const char* qrk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
