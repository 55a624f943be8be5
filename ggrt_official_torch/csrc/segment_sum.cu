// Scatter-add of value rows into a zeroed output: out[ids[i], :] += vals[i, :]
// for ids[i] in [0, g); every other id (the dump row g that dead list
// entries map to) is dropped.
//
// Replaces the TPU kernel ggrt_official_tpu/ops/rasterizer/segment_sum.py
// ::_kernel (launched by scatter_add_rows) together with the sort and the
// searchsorted around it. Those exist only because the TPU has no atomics:
// they put the rows in id order so that each output block can sum a
// contiguous window with a one-hot matmul. Hopper adds floats atomically in
// device memory, so the port scatters the live rows directly.
//   ids  (N,)     int32
//   vals (N, C)   float32
//   out  (g, C)   float32, zeroed by the wrapper
// The record gather's pullback calls it with N = tiles·K list entries,
// C = 9 and g the Gaussian count.
//
// Design. One thread per (row, column) element, consecutive threads on
// consecutive columns of a row, so the reads of vals are coalesced; a
// thread whose id is out of range returns. Each live element is one
// atomicAdd (red.global.add.f32) into out. A Gaussian appears in at most
// max_dup tiles, so at most that many adds meet on one address. The order
// of those adds changes from run to run: a sum of n terms is then
// reproducible to (n-1)·2^-24 of the sum of their magnitudes.
//
// Bound. Bytes: the output is written once (g·C floats, zeroed then added
// to) and the inputs read once, N·(C+1) words; at the full-width train step
// g·C = 31M floats (124 MB) dominate, ~37 µs at 3.35 TB/s. The adds (N·C =
// 1.5M) are negligible.

#include <cuda_runtime.h>

namespace {

__global__ void segment_sum_kernel(const int* __restrict__ ids,
                                   const float* __restrict__ vals,
                                   float* __restrict__ out, long long n,
                                   int C, int g) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * C) return;
  const long long row = i / C;
  const int col = (int)(i - row * C);
  const int id = ids[row];
  if (id < 0 || id >= g) return;
  atomicAdd(&out[(long long)id * C + col], vals[i]);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int segment_sum(const int* ids, const float* vals, float* out,
                           long long n, int C, int g, void* stream) {
  const int threads = 256;
  const long long blocks = (n * C + threads - 1) / threads;
  if (blocks > 0) {
    segment_sum_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        ids, vals, out, n, C, g);
  }
  return (int)cudaGetLastError();
}
