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
// most) and the division is IEEE round-to-nearest (-prec-div=true).
//   x   (n,) float32
//   out (n,) float32
// The main path calls each at (512, 128) (exp, recip) and (8, 128) (log).
//
// Bound. Bytes: each element read once and written once, 8·n bytes; at
// n = 65,536 that is 0.16 µs at 3.35 TB/s, far below a launch's few µs.
// The operations (tens of instructions per element) are no nearer.
// Design: one thread per element, consecutive threads on consecutive
// words (coalesced), no shared memory; nothing more is worth doing at
// these sizes. probe_empty launches the same grid with a body that does
// nothing: its time is the floor the three kernels stand on.

#include <cuda_runtime.h>

namespace {

__global__ void probe_exp_kernel(const float* __restrict__ x, float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = expf(x[i]);
}

__global__ void probe_recip_kernel(const float* __restrict__ x, float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = 1.0f / x[i];
}

__global__ void probe_log_kernel(const float* __restrict__ x, float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = logf(x[i]);
}

__global__ void probe_empty_kernel(const float* __restrict__, float* __restrict__, long long) {}

template <typename Kernel>
int launch(Kernel kernel, const float* x, float* out, long long n, void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(x, out, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() after the launch.
extern "C" int probe_exp(const float* x, float* out, long long n, void* stream) {
  return launch(probe_exp_kernel, x, out, n, stream);
}

extern "C" int probe_recip(const float* x, float* out, long long n, void* stream) {
  return launch(probe_recip_kernel, x, out, n, stream);
}

extern "C" int probe_log(const float* x, float* out, long long n, void* stream) {
  return launch(probe_log_kernel, x, out, n, stream);
}

extern "C" int probe_empty(const float* x, float* out, long long n, void* stream) {
  return launch(probe_empty_kernel, x, out, n, stream);
}
