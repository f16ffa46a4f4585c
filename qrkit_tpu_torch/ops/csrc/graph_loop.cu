// L1: the condition of the LM device loop, and the CUDA graph whose
// conditional WHILE node runs that loop as one launch (sm_90a); L2, the
// stamps a step leaves inside the loop's body.
//
// Replaces no TPU kernel: on the TPU, XLA evaluates the predicate of
// lax.while_loop itself (qrkit_tpu/lm.py:149-151, `it < max_iters and not
// done`, vmapped to `any(not done)` over a batch of problems).  Here the
// loop is a CUDA conditional WHILE node (CUDA >= 12.3), and this kernel is
// what sets its condition from the device state, so no host read happens
// inside a fit.
//
// loop_cond_kernel: one CTA of kThreads threads.  cond = (k < max_iters) &&
// some done[i] == 0: a strided pass over done [n] (bytes, torch.bool), one
// __syncthreads_or, and thread 0 reads the loop counter k, sets the
// conditional handle (cudaGraphSetConditional), adds one to *count (when
// given: the evaluations of a launch, which the loop's tail fetches with
// its result, so the kernel itself counts its launches), writes cond into
// log[k] (when given: one entry per evaluation, so a run can hold every
// evaluation against the plain expression), the device's %globaltimer as
// thread 0 read it on entry into stamps[k] (when given: ns, so consecutive
// stamps bound one iteration of the loop on the device's clock) and cond
// into out (the standalone launch).  Bound: the launch; it reads n + 8 bytes
// (n is the number of problems of a fit, 1 to a few thousand) and writes at
// most 17.
//
// The host functions build, around the graphs PyTorch captured for the
// loop's init, body and tail (torch.cuda.CUDAGraph(keep_graph=True)), one
// graph with the driver API and instantiate it once:
//
//   [init] -> [L1] -> WHILE { [body] -> [L1] } -> [tail]
//
// ([x] a child-graph node holding a clone of PyTorch's graph x; [L1] a
// kernel node of loop_cond_kernel setting the WHILE node's handle.)  The
// L1 node before the loop sets the first condition from the state, so a
// launch whose state is already finished runs the body no time.  The graph
// is built with the driver API: this library links the CUDA runtime
// statically, and PyTorch has its own runtime, so the driver is the one
// runtime that both share (a cudaGraph_t is a CUgraph).
//
// Device: every host function pushes the primary context of the operands'
// device and pops it again (the runtime calls in between use the context
// that is current), and launches on the stream it is given.
//
// Errors: a CUresult is returned as it is; a runtime error as
// kRuntimeBase + cudaError_t; qrk_error_string decodes both.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC graph_loop.cu -lcuda
// (ops/_build.py does this at first use.)

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <new>

#if !defined(CUDA_VERSION) || CUDA_VERSION < 12030
#error "conditional WHILE graph nodes need CUDA 12.3 or later"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kRuntimeBase = 10000;

__device__ __forceinline__ long long global_timer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void __launch_bounds__(kThreads)
loop_cond_kernel(const unsigned char* __restrict__ done, long long n, const int* __restrict__ k,
                 int max_iters, cudaGraphConditionalHandle handle, int set_handle,
                 int* __restrict__ count, int* __restrict__ log, long long* __restrict__ stamps,
                 int log_len, unsigned char* __restrict__ out) {
  const long long entered = (stamps != nullptr && threadIdx.x == 0) ? global_timer() : 0;
  int live = 0;
  for (long long i = threadIdx.x; i < n; i += kThreads) live |= done[i] == 0;
  live = __syncthreads_or(live);
  if (threadIdx.x == 0) {
    const int kk = *k;
    const unsigned int cond = (kk < max_iters && live) ? 1u : 0u;
    if (set_handle) cudaGraphSetConditional(handle, cond);
    if (count != nullptr) *count += 1;
    if (log != nullptr && kk >= 0 && kk < log_len) log[kk] = (int)cond;
    if (stamps != nullptr && kk >= 0 && kk < log_len) stamps[kk] = entered;
    if (out != nullptr) *out = (unsigned char)cond;
  }
}

__global__ void loop_mark_kernel(long long* __restrict__ marks, const int* __restrict__ k,
                                 int slots, int slot, int rows) {
  const long long now = global_timer();
  const int kk = *k;
  if (kk >= 0 && kk < rows) marks[(long long)kk * slots + slot] = now;
}

// The operands of every L1 node of the graph, in the kernel's order.
struct CondArgs {
  const unsigned char* done;
  long long n;
  const int* k;
  int max_iters;
  cudaGraphConditionalHandle handle;
  int set_handle;
  int* count;
  int* log;
  long long* stamps;
  int log_len;
  unsigned char* out;
};

struct LoopGraph {
  CUcontext ctx = nullptr;
  CUdevice device = 0;
  CUgraph graph = nullptr;
  CUgraphExec exec = nullptr;
};

class ContextGuard {
 public:
  explicit ContextGuard(CUcontext ctx) { err_ = cuCtxPushCurrent(ctx); }
  ~ContextGuard() {
    CUcontext popped;
    if (err_ == CUDA_SUCCESS) cuCtxPopCurrent(&popped);
  }
  ContextGuard(const ContextGuard&) = delete;
  ContextGuard& operator=(const ContextGuard&) = delete;
  CUresult error() const { return err_; }

 private:
  CUresult err_;
};

#define QRK_DRV(call)                             \
  do {                                            \
    const CUresult r_ = (call);                   \
    if (r_ != CUDA_SUCCESS) return (int)r_;       \
  } while (0)

// The device of CUDA ordinal `ordinal` and its primary context, retained
// (released by cuDevicePrimaryCtxRelease).
int retain_primary(int ordinal, CUdevice* device, CUcontext* ctx) {
  QRK_DRV(cuDeviceGet(device, ordinal));
  QRK_DRV(cuDevicePrimaryCtxRetain(ctx, *device));
  return 0;
}

int add_cond_node(CUgraph g, const CUgraphNode* deps, size_t ndeps, CUfunction fn, CondArgs a,
                  CUgraphNode* node) {
  void* params[] = {&a.done, &a.n, &a.k, &a.max_iters, &a.handle, &a.set_handle,
                    &a.count, &a.log, &a.stamps, &a.log_len, &a.out};
  CUDA_KERNEL_NODE_PARAMS p;
  std::memset(&p, 0, sizeof p);
  p.func = fn;
  p.gridDimX = p.gridDimY = p.gridDimZ = 1;
  p.blockDimX = kThreads;
  p.blockDimY = p.blockDimZ = 1;
  p.kernelParams = params;
  QRK_DRV(cuGraphAddKernelNode(node, g, deps, ndeps, &p));  // copies the parameters
  return 0;
}

int add_while_node(CUgraph g, const CUgraphNode* deps, size_t ndeps, CUcontext ctx,
                   CUgraphConditionalHandle handle, CUgraphNode* node, CUgraph* body) {
  CUgraphNodeParams p;
  std::memset(&p, 0, sizeof p);
  p.type = CU_GRAPH_NODE_TYPE_CONDITIONAL;
  p.conditional.handle = handle;
  p.conditional.type = CU_GRAPH_COND_TYPE_WHILE;
  p.conditional.size = 1;
  p.conditional.ctx = ctx;
#if CUDA_VERSION >= 13000
  QRK_DRV(cuGraphAddNode(node, g, deps, nullptr, ndeps, &p));
#else
  QRK_DRV(cuGraphAddNode(node, g, deps, ndeps, &p));
#endif
  *body = p.conditional.phGraph_out[0];
  return 0;
}

// [init] -> [L1] -> WHILE { [body] -> [L1] } -> [tail], instantiated; the
// caller has made the primary context current.
int build_graph(LoopGraph* lg, CUgraph init, CUgraph body, CUgraph tail, CondArgs a) {
  cudaFunction_t f;
  const cudaError_t ferr = cudaGetFuncBySymbol(&f, (const void*)loop_cond_kernel);
  if (ferr != cudaSuccess) return kRuntimeBase + (int)ferr;
  const CUfunction fn = (CUfunction)f;
  QRK_DRV(cuGraphCreate(&lg->graph, 0));
  const CUgraph g = lg->graph;
  CUgraphConditionalHandle handle;
  QRK_DRV(cuGraphConditionalHandleCreate(&handle, g, lg->ctx, 0, CU_GRAPH_COND_ASSIGN_DEFAULT));
  a.handle = handle;
  a.set_handle = 1;
  CUgraphNode start, node;
  QRK_DRV(cuGraphAddChildGraphNode(&start, g, nullptr, 0, init));
  if (int err = add_cond_node(g, &start, 1, fn, a, &node)) return err;
  CUgraphNode loop;
  CUgraph body_graph;
  if (int err = add_while_node(g, &node, 1, lg->ctx, handle, &loop, &body_graph)) return err;
  CUgraphNode step;
  QRK_DRV(cuGraphAddChildGraphNode(&step, body_graph, nullptr, 0, body));
  if (int err = add_cond_node(body_graph, &step, 1, fn, a, &node)) return err;
  QRK_DRV(cuGraphAddChildGraphNode(&node, g, &loop, 1, tail));
  QRK_DRV(cuGraphInstantiate(&lg->exec, g, 0));
  return 0;
}

void destroy(LoopGraph* lg) {
  if (lg->ctx != nullptr) {
    {
      const ContextGuard ctx(lg->ctx);
      if (lg->exec != nullptr) cuGraphExecDestroy(lg->exec);
      if (lg->graph != nullptr) cuGraphDestroy(lg->graph);
    }
    cuDevicePrimaryCtxRelease(lg->device);
  }
  delete lg;
}

}  // namespace

extern "C" {

// The standalone L1 launch: out[0] = (k < max_iters) && !all(done), no handle.
int qrk_loop_cond(int device, const unsigned char* done, int64_t n, const int* k, int max_iters,
                  unsigned char* out, cudaStream_t stream) {
  CUdevice dev;
  CUcontext ctx;
  if (int err = retain_primary(device, &dev, &ctx)) return err;
  int err;
  {
    const ContextGuard guard(ctx);
    err = (int)guard.error();
    if (err == 0) {
      loop_cond_kernel<<<1, kThreads, 0, stream>>>(done, (long long)n, k, max_iters, 0, 0, nullptr,
                                                   nullptr, nullptr, 0, out);
      const cudaError_t e = cudaGetLastError();
      err = e == cudaSuccess ? 0 : kRuntimeBase + (int)e;
    }
  }
  cuDevicePrimaryCtxRelease(dev);
  return err;
}

// L2: marks[k * slots + slot] = %globaltimer, one thread (k read on the
// device; rows bounds k).
int qrk_loop_mark(int device, long long* marks, const int* k, int slots, int slot, int rows,
                  cudaStream_t stream) {
  CUdevice dev;
  CUcontext ctx;
  if (int err = retain_primary(device, &dev, &ctx)) return err;
  int err;
  {
    const ContextGuard guard(ctx);
    err = (int)guard.error();
    if (err == 0) {
      loop_mark_kernel<<<1, 1, 0, stream>>>(marks, k, slots, slot, rows);
      const cudaError_t e = cudaGetLastError();
      err = e == cudaSuccess ? 0 : kRuntimeBase + (int)e;
    }
  }
  cuDevicePrimaryCtxRelease(dev);
  return err;
}

// Build the loop's graph around PyTorch's captured graphs; *out receives the
// handle for qrk_loop_launch.  log (int32) and stamps (int64) hold log_len
// entries each.
int qrk_loop_build(int device, void* init_graph, void* body_graph, void* tail_graph,
                   const unsigned char* done, int64_t n, const int* k, int max_iters, int* count,
                   int* log, long long* stamps, int log_len, void** out) {
  *out = nullptr;
  LoopGraph* lg = new (std::nothrow) LoopGraph;
  if (lg == nullptr) return kRuntimeBase + (int)cudaErrorMemoryAllocation;
  if (int err = retain_primary(device, &lg->device, &lg->ctx)) {
    lg->ctx = nullptr;
    destroy(lg);
    return err;
  }
  const CondArgs a{done, (long long)n, k, max_iters, 0, 1, count, log, stamps, log_len, nullptr};
  int err;
  {
    const ContextGuard ctx(lg->ctx);
    err = (int)ctx.error();
    if (err == 0)
      err = build_graph(lg, (CUgraph)init_graph, (CUgraph)body_graph, (CUgraph)tail_graph, a);
  }
  if (err != 0) {
    destroy(lg);
    return err;
  }
  *out = lg;
  return 0;
}

// Launch the loop's graph on `stream`.
int qrk_loop_launch(void* loop, cudaStream_t stream) {
  LoopGraph* lg = static_cast<LoopGraph*>(loop);
  if (lg->exec == nullptr) return (int)CUDA_ERROR_INVALID_VALUE;
  const ContextGuard ctx(lg->ctx);
  QRK_DRV(ctx.error());
  QRK_DRV(cuGraphLaunch(lg->exec, (CUstream)stream));
  return 0;
}

int qrk_loop_destroy(void* loop) {
  if (loop != nullptr) destroy(static_cast<LoopGraph*>(loop));
  return 0;
}

// The driver's CUDA version and this library's runtime (the toolkit's).
int qrk_versions(int* driver, int* runtime) {
  QRK_DRV(cuDriverGetVersion(driver));
  const cudaError_t err = cudaRuntimeGetVersion(runtime);
  return err == cudaSuccess ? 0 : kRuntimeBase + (int)err;
}

const char* qrk_error_string(int code) {
  if (code >= kRuntimeBase) return cudaGetErrorString((cudaError_t)(code - kRuntimeBase));
  const char* s = nullptr;
  if (cuGetErrorString((CUresult)code, &s) != CUDA_SUCCESS || s == nullptr) return "unknown error";
  return s;
}

}  // extern "C"
