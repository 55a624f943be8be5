// The transcendental-precision probe: three elementwise kernels that
// compute expf(x), 1.0f / x and logf(x) in float32 on the card, so that
// tools/diag_exp_precision.py can hold what a hand-written kernel computes
// against torch's own op and against float64.
//
// Replaces the TPU kernels tools/diag_exp_precision.py::_kexp, _krecip
// and _klog (one pl.pallas_call each). There the question was whether
// Mosaic lowers jnp.exp to an approximate exponential that XLA does not
// use. Here it is what the compositors rely on: csrc/composite_cull.cuh
// widens its footprint radius by 4e-3·(r + 1) on the claim that this
// "covers expf's and logf's few ulps". The file is compiled with the
// compositors' NVCC_FLAGS (sm_90a, -O3, no --use_fast_math), so expf and
// logf are the same library calls (CUDA documents 2 ulp and 1 ulp at
// most) and the division is IEEE round-to-nearest (-prec-div=true). No
// fast-math intrinsic appears here: a faster exp would make the probe
// measure another function.
//   x   (n,) float32, contiguous, any 4-byte alignment
//   out (n,) float32
// The main path calls each at (512, 128) (exp, recip) and (8, 128) (log).
//
// Bound: the launch floor. Bytes: each element read once and written
// once, 8·n bytes; at n = 65,536 that is 0.16 µs at 3.35 TB/s (at log's
// 1,024, 0.0024 µs), far below a launch's ~2 µs. The operations (tens of
// instructions per element) are no nearer. What bounds each kernel is the
// time the card takes to start a grid after the one before it and to
// retire it; the body (one load, the function, one store) adds ~0.25 µs.
//
// Design: one thread per element, 256 a block, consecutive threads on
// consecutive words (coalesced), no loop, no shared memory. exp and 1/x
// take a plain <<<>>> launch. log is launched with programmatic dependent
// launch (cudaLaunchKernelEx, cudaLaunchAttributeProgrammaticStreamSerialization):
// the card may start its grid while the grid before it in the stream
// drains, so the floor itself shrinks. Its threads run griddepcontrol.wait
// before any access through x or out (the grid before may still be
// writing x) and then griddepcontrol.launch_dependents, so the next such
// launch may start as early. At (8, 128) on an NVIDIA H100 80GB HBM3 at
// 700 W (20 launches a reading, PERF.md holds the sweep and its command):
// 1.148 µs on a floor of 0.857 against 2.250 on 1.985 with <<<>>> (spread
// 0.094), and 3.108 against 4.303 µs for a copy_ into x followed by log.
// 1 x 1,024 and 8 x 128 gained nothing beyond the spread on either path.
// For exp and 1/x at (512, 128) a float4 grid-stride body (4 or 8
// elements a thread) dispatched up to 0.1 µs faster but took longer (exp
// 2.46-2.64 µs against 2.31) and 128-1,024 threads a block gained nothing
// beyond the spread. probe_log_plain is log's first design (the same grid,
// a <<<>>> launch), kept to be timed beside it. probe_empty and
// probe_empty_pdl launch the same grid on each path with a body that does
// nothing: their time, at each kernel's input, is the floor that kernel
// stands on. probe_late_copy exists to test the wait (see its comment).

#include <cuda_runtime.h>

#include <type_traits>

namespace {

struct Exp {
  static __device__ float f(float v) { return expf(v); }
};
struct Recip {
  static __device__ float f(float v) { return 1.0f / v; }
};
struct Log {
  static __device__ float f(float v) { return logf(v); }
};
struct Empty {};

// Pdl: the kernel is launched with programmatic stream serialization, so
// it may start while the grid before it in the stream is still draining.
// griddepcontrol.wait then holds every thread until that grid has finished
// and its writes are visible; no access through x or out comes before it.
// launch_dependents lets the next such launch start early in turn (it too
// waits for this grid's end before it touches memory).
template <class Op, bool Pdl>
__global__ void per_element_kernel(const float* __restrict__ x, float* __restrict__ out, long long n) {
  if constexpr (Pdl) {
    asm volatile("griddepcontrol.wait;" ::: "memory");
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  }
  if constexpr (!std::is_same_v<Op, Empty>) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = Op::f(x[i]);
  }
}

// One thread per element, 256 a block. Returns the launch's error code:
// cudaLaunchKernelEx's for a programmatic launch, cudaGetLastError() after
// a <<<>>> launch.
template <class Op, bool Pdl>
int launch(const float* x, float* out, long long n, void* stream) {
  constexpr int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks == 0) return (int)cudaGetLastError();
  if constexpr (Pdl) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, per_element_kernel<Op, true>, x, out, n);
  } else {
    per_element_kernel<Op, false><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(x, out, n);
    return (int)cudaGetLastError();
  }
}

// A writer that a programmatic launch behind it would race without
// griddepcontrol.wait: every block first lets the next grid in the stream
// start (launch_dependents), then idles ~50 µs on the global timer, and
// only then copies src into x. A dependent that read x before its wait
// would read what x held before this copy.
__global__ void late_copy_kernel(const float* __restrict__ src, float* __restrict__ x, long long n) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  do {
    __nanosleep(1000);
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  } while (t - t0 < 50000ull);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = src[i];
}

}  // namespace

// Each launches on `stream` and returns the launch's error code.
extern "C" int probe_exp(const float* x, float* out, long long n, void* stream) {
  return launch<Exp, false>(x, out, n, stream);
}

extern "C" int probe_recip(const float* x, float* out, long long n, void* stream) {
  return launch<Recip, false>(x, out, n, stream);
}

extern "C" int probe_log(const float* x, float* out, long long n, void* stream) {
  return launch<Log, true>(x, out, n, stream);
}

extern "C" int probe_log_plain(const float* x, float* out, long long n, void* stream) {
  return launch<Log, false>(x, out, n, stream);
}

extern "C" int probe_empty(const float* x, float* out, long long n, void* stream) {
  return launch<Empty, false>(x, out, n, stream);
}

extern "C" int probe_empty_pdl(const float* x, float* out, long long n, void* stream) {
  return launch<Empty, true>(x, out, n, stream);
}

// src (n,) float32 copied into x (n,) ~50 µs after the grid starts, on a
// <<<>>> launch of 256 a block (late_copy_kernel).
extern "C" int probe_late_copy(const float* src, float* x, long long n, void* stream) {
  const long long blocks = (n + 255) / 256;
  if (blocks > 0) late_copy_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(src, x, n);
  return (int)cudaGetLastError();
}
