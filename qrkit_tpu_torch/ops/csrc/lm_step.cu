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
// right block (M2 columns) and BL residuals, in ONE cooperative launch a
// step (lm_step_kernel):
//
//   tasks       A persistent grid of min(C, P * segs) CTAs, C = kCtas (the
//               grid follows the shapes alone).  Problem p's tiles of
//               blockDim.x points split into segs = min(tiles, max(1, C / P))
//               contiguous runs; task (p, s) is run s of problem p, and CTA
//               b takes tasks b, b + grid, ...  Thread t of a task takes
//               point tile * blockDim.x + t of each tile of the run.
//   point pass  Per point: the damped point block [left_i; sqrt(lam) I_BC]
//               and its [right_i | -res_i] rows in registers, BC unrolled
//               Householder steps -> the point's factor rows (R1 packed, r12,
//               y1) and its BL complement rows of [right | -res].  Where
//               the factor rows go to memory, a thread's operands of its
//               next tiles are copied into shared memory (cp.async) while
//               it reduces the current ones.
//   carry       The thread absorbs its points' complement rows into its
//               running [R | Q^T y] (an M2 x (M2 + 1) upper triangle in
//               registers) by a Householder QR of [carry; rows], kBatch
//               points' rows at a time: no communication.  Then the warp
//               merges its 32 triangles (a column-wise QR of the stacked
//               triangles, lane 0's the pivot rows, shuffles alone) and
//               warp 0 the warps' (one barrier): the task's partial.
//   finish      The task writes its partial and takes an atomic ticket per
//               problem (acq_rel: it releases the partial and acquires the
//               others'); the last CTA to arrive reduces the problem's segs
//               partials and the sqrt(lam) I_M2 tail in index order (thread
//               t the contiguous block t*k .. t*k + k - 1, then the CTA
//               merge), runs the M2 x M2 back-substitution, writes x2 and
//               sets the problem's flag (release).  The order of the sums
//               never depends on the order of arrival, so two calls give
//               the same bits.
//   x1          Every CTA acquires its tasks' flags (the cooperative launch
//               makes every CTA co-resident, so the wait cannot starve the
//               finisher) and writes x1 = R1^-1 (y1 - r12 x2) for its
//               points: from registers when the CTA has one task of at most
//               kRegPoints tiles, else from the factor rows it wrote to
//               device memory (read back from L2).
//
// The launcher first zeroes the call's ticket and flag words (one memset
// node, in a buffer the call owns), so a graph replay and two calls on two
// streams each start clean.  The mesh form splits the launch: kPartial
// stops at the rank's one partial (the last CTA reduces the task partials
// without the tail); after the all-gather, kFinish reduces the gathered
// partials with the tail in CTA 0 and every CTA writes x1 from the factor
// rows.
//
// Layout (lane-major, the point axis last and contiguous, as the reference
// keeps it): left [P, BL, BC, nb], right [P, BL, M2, nb], res [P, BL, nb],
// lam [P] over P independent problems (the vmapped batch fit; P = 1
// otherwise).  Factor rows fac [P, NF, nb]: per BC row j the packed R1 row
// R1[j][j..BC-1], then per row j its r12[j][0..M2-1] and y1[j].  A partial
// stack [P, M2 + 1, parts * M2]: rows 0..M2-1 are the triangle's columns
// (lane l of row c holds R[l][c], l <= c, else 0), row M2 is Q^T y; partial
// q owns lanes q*M2 .. q*M2 + M2 - 1.  The output [P, stride]: x1 [BC, nb]
// then x2 [M2] (the flat step of the bc = 1 form written in place).
//
// Bound: bytes.  At the ellipse's shape (BL 2, BC 1, M2 5, fp32) a point
// reads 56 bytes and writes 4: 6.0 MB, 1.8 us at 3.35 TB/s at 100k points.
// The factor rows stay in registers at 100k (28 B a point at 500k go to L2
// and back).  The arithmetic is some 400 flops a point.  What is left is
// latency: a thread's chain of absorbs, the warp and CTA merges (M2 columns,
// a sqrt and a division each), one ticket, the finisher's merges and the
// flag.
//
// Numerics: true division and sqrt, and the build turns off FMA contraction
// (--fmad=false).  No atomic adds a value: every sum runs in a fixed order,
// which ops/lm_step.py's plain version mirrors step by step (the absorbs,
// the butterfly warp sums, the merges, the finish), so the CPU tests cover
// the order the card sums in.
//
// Device: each launcher makes its operands' device current for the launch
// and the caller's device current again after it (DeviceGuard), then
// launches on the stream it is given; it returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -DQRK_BL=<rows> -DQRK_BC=<cols> -DQRK_M2=<right cols>
// (ops/_build.py does this at first use, one library per (BL, BC, M2)).
// Measurement builds only (profile_lm_step.py): -DQRK_CTAS=<C> another grid
// size, -DQRK_TRACE=1 the marks inside, -DQRK_STAGE=0 the factor-rows
// path's operands loaded to registers without staging.

#include <cuda_runtime.h>
#include <cstdint>

#if !defined(QRK_BL) || !defined(QRK_BC) || !defined(QRK_M2)
#error "compile with -DQRK_BL=<block rows> -DQRK_BC=<block cols> -DQRK_M2=<right cols>"
#endif

namespace {

constexpr int kBL = QRK_BL, kBC = QRK_BC, kM2 = QRK_M2;
constexpr int kBR = kBL + kBC;                       // rows of a damped point block
constexpr int kR = kM2 + 1;                          // carry columns: the M2 columns, then y
constexpr int kNF = kBC * (kBC + 1) / 2 + kBC * kR;  // factor rows a point
constexpr int kThreads = 256;                        // points a tile, threads a CTA (at most)
constexpr int kMaxWarps = kThreads / 32;
#ifdef QRK_CTAS
constexpr int kCtas = QRK_CTAS;                      // a sweep's build (profile_lm_step.py)
#else
constexpr int kCtas = 132;                           // C: CTAs of the persistent grid
#endif
// ops/lm_step.py's TILE and CTAS mirror kThreads and the default C
static_assert(kThreads == 256 && kCtas >= 1, "ops/lm_step.py");
static_assert(kBL >= 1 && kBC >= 1 && kM2 >= 1 && kM2 <= 16, "1 <= BL, 1 <= BC, 1 <= M2 <= 16");

constexpr int clamp(int v, int hi) { return v < 1 ? 1 : (v > hi ? hi : v); }
// tiles a task keeps in registers (its factor rows, within 64 words a
// thread, at most 8: the vmapped batch's 5 at C = 132)
template <typename T>
constexpr int kRegPoints = clamp(64 / (kNF * (int)(sizeof(T) / 4)), 8);
// points a thread absorbs at once, their rows stacked (within 48 words)
template <typename T>
constexpr int kBatch = clamp(48 / (kBL * kR * (int)(sizeof(T) / 4)), 4);
constexpr int kOps = kBL * kBC + kBL * kM2 + kBL;  // a point's operands: left, right, res

#ifdef QRK_TRACE
// A build with -DQRK_TRACE=1 (profile_lm_step.py --case trace) times the
// kernel inside: thread 0 of each of the first kTraceCtas CTAs writes its
// %globaltimer and SM clock at each mark (lm_step_kernel) to g_trace, read
// back by qrk_lm_trace.  The default build's marks compile to nothing.
constexpr int kTraceSlots = 7;
constexpr int kTraceCtas = 1024;
__device__ unsigned long long g_trace[kTraceCtas * kTraceSlots * 2];
#endif

__device__ __forceinline__ void mark(int slot) {
#ifdef QRK_TRACE
  if (threadIdx.x == 0 && blockIdx.x < kTraceCtas) {
    unsigned long long g;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
    g_trace[(blockIdx.x * kTraceSlots + slot) * 2] = g;
    g_trace[(blockIdx.x * kTraceSlots + slot) * 2 + 1] = (unsigned long long)clock64();
  }
#endif
}

enum Mode { kFull = 0, kPartial = 1, kFinish = 2 };

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

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned atomic_add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// the butterfly: every lane ends with the same bits (a + b == b + a)
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

template <typename T>
__device__ __forceinline__ void zero_rows(T (&rows)[kBL][kR]) {
#pragma unroll
  for (int i = 0; i < kBL; ++i)
#pragma unroll
    for (int c = 0; c < kR; ++c) rows[i][c] = T(0);
}

template <typename T>
__device__ __forceinline__ void zero(T (&cr)[kM2][kR]) {
#pragma unroll
  for (int i = 0; i < kM2; ++i)
#pragma unroll
    for (int c = 0; c < kR; ++c) cr[i][c] = T(0);
}

// The reflector of a carry column (pivot x0, squared tail sigma): beta and
// c = 1/(beta (beta - x0)); degenerate (c = 0, the column left as it is)
// where the tail is zero or beta (beta - x0) is below the smallest normal
// number: a carry of fewer rows than M2 holds columns of rounding noise,
// whose reciprocal would overflow.
template <typename T>
constexpr T kTinyNormal = T(0);
template <>
constexpr float kTinyNormal<float> = 1.17549435e-38f;  // FLT_MIN
template <>
constexpr double kTinyNormal<double> = 2.2250738585072014e-308;  // DBL_MIN

template <typename T>
__device__ __forceinline__ bool carry_reflector(T x0, T sigma, T& beta, T& c) {
  const T norm = sqrt(x0 * x0 + sigma);
  beta = x0 >= T(0) ? -norm : norm;
  const T t = beta * (beta - x0);
  const bool degen = sigma <= T(0) || t < kTinyNormal<T>;
  c = degen ? T(0) : T(1) / t;
  return degen;
}

// The Householder QR of [cr; rows] into cr (rows: G groups of L rows, stacked
// in group order): per column j the pivot cr[j][j],
// the tail rows[.][j], beta = -sign(x0)||x||, c = 1/(beta (beta - x0)) (0 for
// a degenerate column: carry_reflector), w_r = c (cr[j][r] (x0 - beta) + sum_l rows[l][r] rows[l][j])
// and the update of row j of cr and of the rows past column j.  TRI: the
// rows are an upper triangle (row l zero before column l), whose zeros are
// skipped (adding them would change no bit).
template <typename T, int G, int L, bool TRI>
__device__ __forceinline__ void absorb(T (&cr)[kM2][kR], T (&rows3)[G][L][kR]) {
  // the G groups of L rows as one stack of G * L rows, in group order
  T (&rows)[G * L][kR] = reinterpret_cast<T (&)[G * L][kR]>(rows3);
#pragma unroll
  for (int j = 0; j < kM2; ++j) {
    const T x0 = cr[j][j];
    T sigma = T(0);
#pragma unroll
    for (int l = 0; l < G * L; ++l)
      if (!TRI || l <= j) sigma = sigma + rows[l][j] * rows[l][j];
    T beta, c;
    const bool degen = carry_reflector(x0, sigma, beta, c);
    const T ud = x0 - beta;
#pragma unroll
    for (int r = j + 1; r < kR; ++r) {
      T acc = cr[j][r] * ud;
#pragma unroll
      for (int l = 0; l < G * L; ++l)
        if (!TRI || l <= j) acc = acc + rows[l][r] * rows[l][j];
      const T w = c * acc;
      cr[j][r] = cr[j][r] - w * ud;
#pragma unroll
      for (int l = 0; l < G * L; ++l)
        if (!TRI || l <= j) rows[l][r] = rows[l][r] - w * rows[l][j];
    }
    cr[j][j] = degen ? x0 : beta;
  }
}

// The column-wise Householder QR of the warp's 32 stacked triangles, lane
// 0's rows the pivots: per column j every other lane sums its rows'
// products (rows 0..j: below them a triangle is zero in column j), the
// butterfly adds the lanes, lane 0 broadcasts its pivot row, and every lane
// updates its rows.  Lane 0 ends with the merged carry.  Shuffles alone.
template <typename T>
__device__ __forceinline__ void warp_merge(T (&cr)[kM2][kR]) {
  const bool pivot = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int j = 0; j < kM2; ++j) {
    // a lane's reflector entries for its rows 0..j: lane 0's are 0 (x0 - beta
    // on its pivot row, set below), every other lane's its column j; so
    // every lane runs the same instructions
    T u[kM2];
#pragma unroll
    for (int l = 0; l <= j; ++l) u[l] = pivot ? T(0) : cr[l][j];
    T tot[kR], piv[kR];
#pragma unroll
    for (int r = j; r < kR; ++r) {
      T part = T(0);
#pragma unroll
      for (int l = 0; l <= j; ++l) part = part + cr[l][r] * u[l];
      tot[r] = warp_sum(part);
      piv[r] = __shfl_sync(0xffffffffu, cr[j][r], 0);
    }
    const T x0 = piv[j], sigma = tot[j];
    T beta, c;
    const bool degen = carry_reflector(x0, sigma, beta, c);
    const T ud = x0 - beta;
    if (pivot) u[j] = ud;
#pragma unroll
    for (int r = j + 1; r < kR; ++r) {
      const T w = c * (tot[r] + piv[r] * ud);
#pragma unroll
      for (int l = 0; l <= j; ++l) cr[l][r] = cr[l][r] - w * u[l];
    }
    if (pivot) cr[j][j] = degen ? x0 : beta;
  }
}

// The warps' carries a CTA merge exchanges.
template <typename T>
struct MergeScratch {
  T carry[kMaxWarps][kM2][kR];
};

// The CTA's carries to one, in thread 0: each warp merges its lanes, then
// warp 0 merges the warps' carries (lanes past the warps hold zeros, which
// change no bit): one barrier.
template <typename T>
__device__ __forceinline__ void cta_merge(T (&cr)[kM2][kR], MergeScratch<T>& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  warp_merge(cr);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kM2; ++i)
#pragma unroll
      for (int c = i; c < kR; ++c) s.carry[warp][i][c] = cr[i][c];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < kM2; ++i)
#pragma unroll
      for (int c = 0; c < kR; ++c) cr[i][c] = (lane < nw && c >= i) ? s.carry[lane][i][c] : T(0);
    warp_merge(cr);
  }
  __syncthreads();  // the scratch is free again
}

// A carry as partial q of a stack with row stride ld.
template <typename T>
__device__ __forceinline__ void write_partial(const T (&cr)[kM2][kR], T* __restrict__ out, int64_t ld,
                                              int64_t q) {
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int l = 0; l < kM2; ++l)
      out[(int64_t)r * ld + q * kM2 + l] = (r == kM2 || l <= r) ? cr[l][r] : T(0);
}

// The finish's triangles into the threads' carries, for a CTA merge: the Q
// partials of a stack (row stride ld), then (TAIL) the sqrt(lam) I_M2 tail
// as one more; thread t copies the first of its contiguous block t*k ..
// t*k + k - 1 (k = ceil(count / blockDim.x)) and absorbs the rest in index
// order.  The partials are read past L1 (__ldcg): other CTAs wrote them
// during this launch.
template <typename T, bool TAIL>
__device__ __forceinline__ void load_partials(const T* __restrict__ stack, int64_t ld, int64_t Q, T sl,
                                              T (&cr)[kM2][kR]) {
  const int64_t count = Q + (TAIL ? 1 : 0);
  const int64_t k = (count + blockDim.x - 1) / blockDim.x;
  const int64_t q0 = (int64_t)threadIdx.x * k;
  const int64_t q1 = q0 + k < count ? q0 + k : count;
  zero(cr);
  for (int64_t q = q0; q < q1; ++q) {
    T rows[1][kM2][kR];
#pragma unroll
    for (int l = 0; l < kM2; ++l)
#pragma unroll
      for (int c = 0; c < kR; ++c)
        rows[0][l][c] = c < l ? T(0)
                        : q < Q ? __ldcg(stack + (int64_t)c * ld + q * kM2 + l)
                                : (c == l ? sl : T(0));  // the tail
    if (q == q0) {
#pragma unroll
      for (int l = 0; l < kM2; ++l)
#pragma unroll
        for (int c = 0; c < kR; ++c) cr[l][c] = rows[0][l][c];
    } else {
      absorb<T, 1, kM2, true>(cr, rows);
    }
  }
}

// R x2 = (Q^T y)[:M2] from thread 0's carry, into x2 [M2].
template <typename T>
__device__ __forceinline__ void solve_x2(const T (&cr)[kM2][kR], T* __restrict__ x2) {
  T x[kM2];
#pragma unroll
  for (int i = kM2 - 1; i >= 0; --i) {
    T acc = cr[i][kM2];
#pragma unroll
    for (int c = i + 1; c < kM2; ++c) acc = acc - cr[i][c] * x[c];
    x[i] = acc / cr[i][i];
  }
#pragma unroll
  for (int i = 0; i < kM2; ++i) x2[i] = x[i];
}

// A point's operands: its block left_i and its rows of [right | -res].
template <typename T>
struct PointOps {
  T a[kBL][kBC];
  T b[kBL][kR];
};

template <typename T>
__device__ __forceinline__ void load_point(PointOps<T>& o, const T* __restrict__ left,
                                           const T* __restrict__ right, const T* __restrict__ res,
                                           int64_t nb, int64_t p) {
#pragma unroll
  for (int i = 0; i < kBL; ++i) {
#pragma unroll
    for (int c = 0; c < kBC; ++c) o.a[i][c] = left[(int64_t)(i * kBC + c) * nb + p];
#pragma unroll
    for (int c = 0; c < kM2; ++c) o.b[i][c] = right[(int64_t)(i * kM2 + c) * nb + p];
    o.b[i][kM2] = -res[(int64_t)i * nb + p];
  }
}

// The operands of a thread's points of tiles tile .. tile + B - 1 (those
// before t1 and the problem's end).
template <typename T, int B>
__device__ __forceinline__ void load_points(PointOps<T> (&o)[B], const T* __restrict__ left,
                                            const T* __restrict__ right, const T* __restrict__ res,
                                            int64_t nb, int64_t tile, int64_t t1, int64_t S, int t) {
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int64_t p = (tile + b) * S + t;
    if (tile + b < t1 && p < nb) load_point(o[b], left, right, res, nb, p);
  }
}

#ifndef QRK_STAGE
#define QRK_STAGE 1
#endif
// The factor-rows path stages its operands: each thread copies its own
// points' operands of the next B tiles into shared memory (cp.async, two
// buffers, 112 KB a CTA at the ellipse's shape) while it reduces the
// current B, which it reads from the other buffer (on an H100: 36.7 -> 35.7
// us at 500k points against -DQRK_STAGE=0, profile_lm_step.py --case
// stage).  Slot (buf, b, op) of thread t:
// stage[((buf * B + b) * kOps + op) * kThreads + t].  A step shape whose
// buffers do not fit beside the merge scratch in the 227 KB a block may use
// loads its operands to registers (decided here, from the shape alone).
template <typename T>
constexpr size_t kStageBytes = 2 * kBatch<T> * kOps * kThreads * sizeof(T);
template <typename T>
constexpr bool kStaged = QRK_STAGE && kStageBytes<T> + sizeof(MergeScratch<T>) + 64 <= 232448;

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src), "n"(sizeof(T)) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Starts the copies of a thread's points of tiles tile .. tile + B - 1
// (those before t1 and the problem's end) into buffer buf, one group.
template <typename T, int B>
__device__ __forceinline__ void stage_points(T* stage, int buf, const T* __restrict__ left,
                                             const T* __restrict__ right, const T* __restrict__ res,
                                             int64_t nb, int64_t tile, int64_t t1, int64_t S, int t) {
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int64_t p = (tile + b) * S + t;
    if (tile + b < t1 && p < nb) {
      T* d = stage + (int64_t)((buf * B + b) * kOps) * kThreads + t;
#pragma unroll
      for (int e = 0; e < kBL * kBC; ++e) cp_async(d + e * kThreads, left + (int64_t)e * nb + p);
#pragma unroll
      for (int e = 0; e < kBL * kM2; ++e)
        cp_async(d + (kBL * kBC + e) * kThreads, right + (int64_t)e * nb + p);
#pragma unroll
      for (int i = 0; i < kBL; ++i) cp_async(d + (kBL * kBC + kBL * kM2 + i) * kThreads, res + (int64_t)i * nb + p);
    }
  }
  cp_async_commit();
}

// A point's operands from its slot of buffer buf, as load_point.
template <typename T, int B>
__device__ __forceinline__ void unstage_point(PointOps<T>& o, const T* stage, int buf, int b, int t) {
  const T* d = stage + (int64_t)((buf * B + b) * kOps) * kThreads + t;
#pragma unroll
  for (int i = 0; i < kBL; ++i) {
#pragma unroll
    for (int c = 0; c < kBC; ++c) o.a[i][c] = d[(i * kBC + c) * kThreads];
#pragma unroll
    for (int c = 0; c < kM2; ++c) o.b[i][c] = d[(kBL * kBC + i * kM2 + c) * kThreads];
    o.b[i][kM2] = -d[(kBL * kBC + kBL * kM2 + i) * kThreads];
  }
}

// The point pass: BC Householder steps on the damped block [left_i; sqrt(lam)
// I_BC] and its rows [right_i | -res_i; 0]; column j itself is not updated,
// its diagonal goes to R1 (beta, or x0 where the column is zero below it).
// Writes the factor rows f and the BL complement rows.
template <typename T>
__device__ __forceinline__ void point_pass(const PointOps<T>& o, T sl, T (&f)[kNF], T (&rows)[kBL][kR]) {
  T a[kBR][kBC], B[kBR][kR];
#pragma unroll
  for (int i = 0; i < kBL; ++i) {
#pragma unroll
    for (int c = 0; c < kBC; ++c) a[i][c] = o.a[i][c];
#pragma unroll
    for (int c = 0; c < kR; ++c) B[i][c] = o.b[i][c];
  }
#pragma unroll
  for (int i = 0; i < kBC; ++i) {
#pragma unroll
    for (int c = 0; c < kBC; ++c) a[kBL + i][c] = i == c ? sl : T(0);
#pragma unroll
    for (int c = 0; c < kR; ++c) B[kBL + i][c] = T(0);
  }
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
  int e = 0;
#pragma unroll
  for (int j = 0; j < kBC; ++j)
#pragma unroll
    for (int col = j; col < kBC; ++col) f[e++] = r1[j][col];
#pragma unroll
  for (int j = 0; j < kBC; ++j)
#pragma unroll
    for (int col = 0; col < kR; ++col) f[e++] = B[j][col];
#pragma unroll
  for (int i = 0; i < kBL; ++i)
#pragma unroll
    for (int r = 0; r < kR; ++r) rows[i][r] = B[kBC + i][r];
}

// x1 = R1^-1 (y1 - r12 x2) of one point from its factor rows.
template <typename T>
__device__ __forceinline__ void point_x1(const T (&f)[kNF], const T (&x2)[kM2], T* __restrict__ out,
                                         int64_t nb, int64_t p) {
  T r1[kBC][kBC];
  int e = 0;
#pragma unroll
  for (int j = 0; j < kBC; ++j)
#pragma unroll
    for (int col = j; col < kBC; ++col) r1[j][col] = f[e++];
  T rhs[kBC];
#pragma unroll
  for (int j = 0; j < kBC; ++j) {
    T s = T(0);
#pragma unroll
    for (int c = 0; c < kM2; ++c) s = s + f[e + c] * x2[c];
    rhs[j] = f[e + kM2] - s;
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

struct Geometry {
  int64_t tiles, segs, grid;
  bool reg;
};

// The task schedule (ops/lm_step.py `schedule` mirrors it).
template <typename T>
Geometry geometry(int64_t nb, int64_t nprob, int64_t tile) {
  Geometry g;
  g.tiles = nb > 0 ? (nb + tile - 1) / tile : 1;
  const int64_t per = kCtas / nprob > 1 ? kCtas / nprob : 1;
  g.segs = g.tiles < per ? g.tiles : per;
  const int64_t tasks = nprob * g.segs;
  g.grid = tasks < kCtas ? tasks : kCtas;
  g.reg = tasks <= g.grid && (g.tiles + g.segs - 1) / g.segs <= kRegPoints<T>;
  return g;
}

// One launch a step (kFull), or the mesh form's two (kPartial, then kFinish
// after the all-gather).  ticket / flag: nprob zeroed words each.
template <typename T, int MODE, bool REG>
__global__ void __launch_bounds__(kThreads)
lm_step_kernel(const T* __restrict__ left, const T* __restrict__ right, const T* __restrict__ res,
               const T* __restrict__ lam, T* __restrict__ fac, T* __restrict__ stack,
               const T* __restrict__ stack_in, int64_t q_in, T* __restrict__ out, int64_t stride,
               unsigned* __restrict__ ticket, unsigned* __restrict__ flag, int64_t nb, int64_t nprob,
               int64_t segs, int64_t tiles) {
  __shared__ MergeScratch<T> smem;
  __shared__ int last;
  const int t = threadIdx.x;
  const int64_t S = blockDim.x, tasks = nprob * segs;
  constexpr int kRegs = REG ? kRegPoints<T> : 1, B = kBatch<T>;
  T fr[kRegs][kNF];  // REG: the factor rows of the CTA's one task
  T cr[kM2][kR];
  // the marks (QRK_TRACE builds): entry (0), after the CTA's points (1),
  // after its merge (2), after the ticket (3), after the finish (4, the
  // finisher), after the flag (5) and at exit (6)
  mark(0);

  if constexpr (MODE != kFinish) {
    for (int64_t task = blockIdx.x; task < tasks; task += gridDim.x) {
      const int64_t prob = task / segs, seg = task % segs;
      const int64_t t0 = seg * tiles / segs, t1 = (seg + 1) * tiles / segs;
      const T* l = left + prob * kBL * kBC * nb;
      const T* r = right + prob * kBL * kM2 * nb;
      const T* v = res + prob * kBL * nb;
      const T sl = sqrt(lam[prob]);
      zero(cr);
      // a thread's points of the run, B tiles at a time: their rows absorbed
      // as one stack (zeros for points past the run or the problem)
      if constexpr (REG) {
#pragma unroll
        for (int k0 = 0; k0 < kRegs; k0 += B) {
          if (t0 + k0 >= t1) break;  // past the run (the same for the whole CTA)
          T rows[B][kBL][kR];
#pragma unroll
          for (int b = 0; b < B; ++b) {
            const int k = k0 + b;
            const int64_t p = (t0 + k) * S + t;
            if (k < kRegs && t0 + k < t1 && p < nb) {
              PointOps<T> o;
              load_point(o, l, r, v, nb, p);
              point_pass(o, sl, fr[k < kRegs ? k : 0], rows[b]);
            } else {
              zero_rows(rows[b]);
            }
          }
          absorb<T, B, kBL, false>(cr, rows);
        }
      } else {
        T* fp = fac + prob * kNF * nb;
        extern __shared__ __align__(16) unsigned char stage_raw[];
        T* stage = reinterpret_cast<T*>(stage_raw);
        int buf = 0;
        if constexpr (kStaged<T>) stage_points<T, B>(stage, 0, l, r, v, nb, t0, t1, S, t);
        for (int64_t tile = t0; tile < t1 && tile * S + t < nb; tile += B) {
          PointOps<T> cur[B];
          if constexpr (kStaged<T>) {
            stage_points<T, B>(stage, buf ^ 1, l, r, v, nb, tile + B, t1, S, t);
            cp_async_wait<1>();  // this chunk's group has landed
#pragma unroll
            for (int b = 0; b < B; ++b) unstage_point<T, B>(cur[b], stage, buf, b, t);
            buf ^= 1;
          } else {
            load_points(cur, l, r, v, nb, tile, t1, S, t);
          }
          T rows[B][kBL][kR];
#pragma unroll
          for (int b = 0; b < B; ++b) {
            const int64_t p = (tile + b) * S + t;
            if (tile + b < t1 && p < nb) {
              T f[kNF];
              point_pass(cur[b], sl, f, rows[b]);
#pragma unroll
              for (int e = 0; e < kNF; ++e) fp[(int64_t)e * nb + p] = f[e];
            } else {
              zero_rows(rows[b]);
            }
          }
          absorb<T, B, kBL, false>(cr, rows);
        }
        if constexpr (kStaged<T>) cp_async_wait<0>();  // nothing in flight past the run
      }
      mark(1);
      const int64_t ld = segs * kM2;
      T* st = stack + prob * kR * ld;
      // the task's merge and, in the problem's last task, the finish's run
      // through one copy of cta_merge: the finisher's code is then the
      // code its CTA has just run (a second copy, cold, measured 2-3x slower
      // in the kernels whose point loop is a runtime loop)
      bool finish = false;
#pragma unroll 1
      for (;;) {
        cta_merge(cr, smem);
        if (finish) break;
        mark(2);
        if (t == 0) {  // the ticket releases the partial and acquires the others'
          write_partial(cr, st, ld, seg);
          last = atomic_add_acq_rel(ticket + prob, 1u) == (unsigned)(segs - 1);
        }
        __syncthreads();
        mark(3);
        if (!last) break;
        load_partials<T, MODE == kFull>(st, ld, segs, sl, cr);
        finish = true;
      }
      if (finish) {
        if (t == 0) {
          if constexpr (MODE == kFull) {
            solve_x2(cr, out + prob * stride + kBC * nb);
            st_release(flag + prob, 1u);
          } else {
            write_partial(cr, out + prob * kR * kM2, kM2, 0);
          }
        }
        mark(4);
      }
      __syncthreads();  // `last` is written again by the next task
    }
  } else {
    if (blockIdx.x == 0) {
      for (int64_t prob = 0; prob < nprob; ++prob) {
        load_partials<T, true>(stack_in + prob * kR * q_in * kM2, q_in * kM2, q_in, sqrt(lam[prob]), cr);
        cta_merge(cr, smem);
        if (t == 0) {
          solve_x2(cr, out + prob * stride + kBC * nb);
          st_release(flag + prob, 1u);
        }
      }
    }
  }

  if constexpr (MODE != kPartial) {
    for (int64_t task = blockIdx.x; task < tasks; task += gridDim.x) {
      const int64_t prob = task / segs, seg = task % segs;
      const int64_t t0 = seg * tiles / segs, t1 = (seg + 1) * tiles / segs;
      if (t == 0) {
        while (ld_acquire(flag + prob) == 0u) __nanosleep(64);
      }
      __syncthreads();
      mark(5);
      T* o = out + prob * stride;
      T x2[kM2];
#pragma unroll
      for (int c = 0; c < kM2; ++c) x2[c] = __ldcg(o + kBC * nb + c);
      if constexpr (REG) {
#pragma unroll
        for (int k = 0; k < kRegs; ++k) {
          const int64_t p = (t0 + k) * S + t;
          if (t0 + k < t1 && p < nb) point_x1(fr[k], x2, o, nb, p);
        }
      } else {
        const T* fp = fac + prob * kNF * nb;
        for (int64_t tile = t0; tile < t1 && tile * S + t < nb; tile += B) {  // B points' rows at once
          T f[B][kNF];
#pragma unroll
          for (int b = 0; b < B; ++b) {
            const int64_t p = (tile + b) * S + t;
            if (tile + b < t1 && p < nb) {
#pragma unroll
              for (int e = 0; e < kNF; ++e) f[b][e] = fp[(int64_t)e * nb + p];
            }
          }
#pragma unroll
          for (int b = 0; b < B; ++b) {
            const int64_t p = (tile + b) * S + t;
            if (tile + b < t1 && p < nb) point_x1(f[b], x2, o, nb, p);
          }
        }
      }
    }
  }
  mark(6);
}

__global__ void __launch_bounds__(1024) empty_kernel() {}

template <typename K, typename... Args>
cudaError_t launch_cooperative(K kernel, unsigned grid, unsigned block, size_t smem, cudaStream_t stream,
                               Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T, int MODE, bool REG>
cudaError_t launch_mode(const Geometry& g, unsigned block, cudaStream_t stream, const T* left,
                        const T* right, const T* res, const T* lam, T* fac, T* stack, const T* stack_in,
                        int64_t q_in, T* out, int64_t stride, unsigned* ticket, unsigned* flag,
                        int64_t nb, int64_t nprob) {
  size_t smem = 0;
  if (kStaged<T> && !REG && MODE != kFinish) {  // the staged path's two buffers, past the 48 KB default
    smem = kStageBytes<T>;
    const cudaError_t err = cudaFuncSetAttribute(lm_step_kernel<T, MODE, REG>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  return launch_cooperative(lm_step_kernel<T, MODE, REG>, (unsigned)g.grid, block, smem, stream, left,
                            right, res, lam, fac, stack, stack_in, q_in, out, stride, ticket, flag, nb,
                            nprob, g.segs, g.tiles);
}

template <typename T>
cudaError_t launch_step(const T* left, const T* right, const T* res, const T* lam, T* fac, T* stack,
                        const T* stack_in, int64_t q_in, T* out, int64_t stride, unsigned* counters,
                        int64_t nb, int64_t nprob, int64_t tile, int mode, cudaStream_t stream) {
  if (tile < 32 || tile > kThreads || tile % 32 || nprob < 1 || nb < 0 || mode < kFull || mode > kFinish ||
      (mode == kFinish && q_in < 1))
    return cudaErrorInvalidValue;
  const Geometry g = geometry<T>(nb, nprob, tile);
  cudaError_t err = cudaMemsetAsync(counters, 0, 2 * (size_t)nprob * sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  unsigned* ticket = counters;
  unsigned* flag = counters + nprob;
  const unsigned block = (unsigned)tile;
  if (mode == kFull && g.reg)
    err = launch_mode<T, kFull, true>(g, block, stream, left, right, res, lam, fac, stack, stack_in, q_in,
                                      out, stride, ticket, flag, nb, nprob);
  else if (mode == kFull)
    err = launch_mode<T, kFull, false>(g, block, stream, left, right, res, lam, fac, stack, stack_in,
                                       q_in, out, stride, ticket, flag, nb, nprob);
  else if (mode == kPartial)
    err = launch_mode<T, kPartial, false>(g, block, stream, left, right, res, lam, fac, stack, stack_in,
                                          q_in, out, stride, ticket, flag, nb, nprob);
  else
    err = launch_mode<T, kFinish, false>(g, block, stream, left, right, res, lam, fac, stack, stack_in,
                                         q_in, out, stride, ticket, flag, nb, nprob);
  // read (and clear) the launch's error either way: a refused launch is not
  // reported again by the next call
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename F>
int launch_on(int device, F&& enqueue) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  return (int)enqueue();
}

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py).  Each launcher makes
// `device` current, enqueues on the caller's stream of that device, makes
// the caller's device current again, does not synchronize, and returns
// cudaGetLastError() (cudaErrorInvalidValue, without a launch, for a
// geometry it does not take).  The caller allocates every buffer.
//   qrk_lm_step     one memset of counters [2 * nprob] (uint32), then one
//                   cooperative launch of min(kCtas, nprob * segs) CTAs of
//                   `tile` threads (a multiple of 32 in [32, 256]).
//                   fac [P, NF, nb]; stack [P, M2 + 1, segs * M2].
//                   mode 0 (kFull): x1 and x2 into out + prob * stride;
//                   mode 1 (kPartial): the rank's partial into out [P, M2 +
//                   1, M2]; mode 2 (kFinish): x2 from the q_in partials of
//                   stack_in [P, M2 + 1, q_in * M2] with the tail, x1 from
//                   fac (written by a kPartial launch of the same shapes).
//   qrk_lm_geometry tiles, segs, grid and whether the factor rows stay in
//                   registers, for those shapes (out [4]).
//   qrk_lm_empty    an empty kernel on a grid of `grid` CTAs of `block`
//                   threads, cooperative or not: the launch floor.
//   qrk_lm_trace    (QRK_TRACE builds) zeroes the marks (zero != 0) or
//                   copies them to dst [kTraceCtas, kTraceSlots, 2] uint64
//                   on the card: thread 0's %globaltimer and clock64.
extern "C" {

#define QRK_LM_LAUNCHERS(SUF, T)                                                                    \
  int qrk_lm_step_##SUF(int device, const T* left, const T* right, const T* res, const T* lam,      \
                        T* fac, T* stack, const T* stack_in, int64_t q_in, T* out, int64_t stride,  \
                        unsigned* counters, int64_t nb, int64_t nprob, int64_t tile, int mode,      \
                        cudaStream_t stream) {                                                      \
    return launch_on(device, [&] {                                                                  \
      return launch_step<T>(left, right, res, lam, fac, stack, stack_in, q_in, out, stride,         \
                            counters, nb, nprob, tile, mode, stream);                               \
    });                                                                                             \
  }                                                                                                 \
  int qrk_lm_geometry_##SUF(int64_t nb, int64_t nprob, int64_t tile, int64_t* out) {                \
    const Geometry g = geometry<T>(nb, nprob, tile);                                                \
    out[0] = g.tiles;                                                                               \
    out[1] = g.segs;                                                                                \
    out[2] = g.grid;                                                                                \
    out[3] = g.reg;                                                                                 \
    return 0;                                                                                       \
  }

QRK_LM_LAUNCHERS(f32, float)
QRK_LM_LAUNCHERS(f64, double)

#undef QRK_LM_LAUNCHERS

int qrk_lm_empty(int device, int64_t grid, int64_t block, int cooperative, cudaStream_t stream) {
  return launch_on(device, [&] {
    if (grid < 1 || block < 1 || block > 1024) return cudaErrorInvalidValue;
    if (cooperative) {
      const cudaError_t err = launch_cooperative(empty_kernel, (unsigned)grid, (unsigned)block, 0, stream);
      if (err != cudaSuccess) return err;
    } else {
      empty_kernel<<<(unsigned)grid, (unsigned)block, 0, stream>>>();
    }
    return cudaGetLastError();
  });
}

#ifdef QRK_TRACE
int qrk_lm_trace(int device, unsigned long long* dst, int zero, cudaStream_t stream) {
  return launch_on(device, [&] {
    void* marks = nullptr;
    cudaError_t err = cudaGetSymbolAddress(&marks, g_trace);
    if (err != cudaSuccess) return err;
    return zero ? cudaMemsetAsync(marks, 0, sizeof(g_trace), stream)
                : cudaMemcpyAsync(dst, marks, sizeof(g_trace), cudaMemcpyDeviceToDevice, stream);
  });
}
#endif

const char* qrk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
