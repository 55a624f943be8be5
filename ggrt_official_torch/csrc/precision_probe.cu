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
// Bound. Bytes: each element read once and written once, 8·n bytes; at
// n = 65,536 that is 0.16 µs at 3.35 TB/s, far below a launch's ~2 µs.
// The operations (tens of instructions per element) are no nearer. So
// what there is to gain is in the grid the launch dispatches.
//
// Design: one thread per element, 256 a block, consecutive threads on
// consecutive words (coalesced), no loop, no shared memory. A grid of
// float4 loads and stores (4 or 8 elements a thread, grid-stride over at
// most one wave of blocks, a scalar tail and a scalar body for unaligned
// pointers) was timed against it at (512, 128) on an NVIDIA H100 80GB
// HBM3 at 700 W: its empty body dispatches up to 0.1 µs faster, but every
// float4 shape took longer (exp 2.46-2.64 µs, 1/x 2.66-2.96) than one
// thread per element (2.31 / 2.36): the body's time follows the elements
// each thread works through, not the width of its accesses. One thread per
// element at 512 or 1,024 a block gained nothing beyond the run-to-run
// spread, at 128 it lost. PERF.md holds the sweep. probe_empty launches the same
// grid with a body that does nothing: its time, at each kernel's input, is
// the floor that kernel stands on.

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

template <class Op>
__global__ void per_element_kernel(const float* __restrict__ x, float* __restrict__ out, long long n) {
  if constexpr (!std::is_same_v<Op, Empty>) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = Op::f(x[i]);
  }
}

template <class Op>
int launch(const float* x, float* out, long long n, void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0) per_element_kernel<Op><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() after the launch.
extern "C" int probe_exp(const float* x, float* out, long long n, void* stream) {
  return launch<Exp>(x, out, n, stream);
}

extern "C" int probe_recip(const float* x, float* out, long long n, void* stream) {
  return launch<Recip>(x, out, n, stream);
}

extern "C" int probe_log(const float* x, float* out, long long n, void* stream) {
  return launch<Log>(x, out, n, stream);
}

extern "C" int probe_empty(const float* x, float* out, long long n, void* stream) {
  return launch<Empty>(x, out, n, stream);
}
