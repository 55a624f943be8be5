// Forward alpha compositing of per-tile, depth-sorted Gaussian records.
//
// Replaces the TPU kernel ggrt_official_tpu/ops/rasterizer/pallas_composite.py
// ::_fwd_kernel (launched by _fwd_raw). Same inputs and the same four
// outputs:
//   counts  (t,)        int32   list length of each tile
//   records (t, 8, K)   float32 rows [l00, l01, cu, l11, cv, opacity, 0, 0]
//   colors  (t, 4, K)   float32 rows [r, g, b, 0]
//   acc     (t, P, 4)   float32 composited rgb (4th channel 0)
//   tfin    (t, P, 1)   float32 final transmittance
//   tst     (t, P, K/128) float32 transmittance at the start of each chunk;
//                        chunks that never run keep 1
//   nexec   (t,)        int32   chunks the tile executed
// with P = tile_h * tile_w pixels. For pixel (x, y) in tile-centred
// coordinates, u = l00·x + l01·y + cu, v = l11·y + cv and
// alpha = opacity·exp(-(u² + v²)/2). CUDA 3DGS semantics: alpha below 1/255
// is skipped, alpha is clamped at 0.99, and a pixel stops for good when
// T·(1 - alpha) would fall below 1e-4.
//
// Design. One block per tile and one thread per pixel (P ≤ 1024). The tile
// walks its list in 128-Gaussian chunks: the block stages a chunk's six
// record rows and three colour rows in shared memory (9 × 128 floats), then
// every live thread walks the chunk in order with a running product for T.
// The block leaves the chunk loop as soon as no pixel is alive
// (__syncthreads_or), which is the early exit the TPU kernel expressed as a
// whole-tile test. None of the TPU kernel's lane-roll cumprod, masked lane
// selects or (8, 128) nexec broadcast is needed here.
//
// Bound. fp32 ALU and SFU (exp) throughput, not bytes. At the full-width
// render (160 tiles of 8×128, K = 1024) the work is at most
// 160 × 1024 × 1024 = 168M (pixel, Gaussian) evaluations at about 20 FLOP
// plus one exp each: tens of microseconds at the H100's 67 TFLOP/s fp32.
// Records and outputs come to about 16 MB, a few microseconds at 3.35 TB/s.
// 160 blocks on 132 SMs is 1.2 waves; that imbalance is left to a later
// redesign of the kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

__global__ void composite_fwd_kernel(
    const int* __restrict__ counts, const float* __restrict__ records,
    const float* __restrict__ colors, float* __restrict__ acc,
    float* __restrict__ tfin, float* __restrict__ tst, int* __restrict__ nexec,
    int K, int tile_h, int tile_w) {
  __shared__ float s_rec[6][kChunk];
  __shared__ float s_col[3][kChunk];

  const int t = blockIdx.x;
  const int P = tile_h * tile_w;
  const int nch = K / kChunk;
  const int p = threadIdx.x;
  const bool has_pixel = p < P;

  const float px = (float)(p % tile_w) - (tile_w - 1) * 0.5f;
  const float py = (float)(p / tile_w) - (tile_h - 1) * 0.5f;

  const int count = max(counts[t], 0);
  const int need = min((count + kChunk - 1) / kChunk, nch);

  const float* rec_t = records + (size_t)t * 8 * K;
  const float* col_t = colors + (size_t)t * 4 * K;
  float* tst_p = tst + ((size_t)t * P + p) * nch;

  float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  bool alive = has_pixel;
  int c = 0;
  for (; c < need; ++c) {
    // Also the barrier that keeps the previous chunk's readers ahead of the
    // staging below.
    if (!__syncthreads_or(alive)) break;
    const int off = c * kChunk;
    for (int i = threadIdx.x; i < 9 * kChunk; i += blockDim.x) {
      const int row = i / kChunk, k = i % kChunk;
      if (row < 6) {
        s_rec[row][k] = rec_t[(size_t)row * K + off + k];
      } else {
        s_col[row - 6][k] = col_t[(size_t)(row - 6) * K + off + k];
      }
    }
    __syncthreads();
    if (has_pixel) tst_p[c] = T;
    if (alive) {
      for (int j = 0; j < kChunk; ++j) {
        const float u = px * s_rec[0][j] + py * s_rec[1][j] + s_rec[2][j];
        const float v = py * s_rec[3][j] + s_rec[4][j];
        const float araw = s_rec[5][j] * expf(-0.5f * (u * u + v * v));
        if (araw < kAlphaMin) continue;
        const float alpha = fminf(araw, kAlphaMax);
        const float T_next = T * (1.0f - alpha);
        if (T_next < kTEps) {
          alive = false;
          break;
        }
        const float w = alpha * T;
        r += w * s_col[0][j];
        g += w * s_col[1][j];
        b += w * s_col[2][j];
        T = T_next;
      }
    }
  }

  if (threadIdx.x == 0) nexec[t] = c;
  if (has_pixel) {
    for (int cc = c; cc < nch; ++cc) tst_p[cc] = 1.0f;
    const size_t q = (size_t)t * P + p;
    tfin[q] = T;
    acc[q * 4 + 0] = r;
    acc[q * 4 + 1] = g;
    acc[q * 4 + 2] = b;
    acc[q * 4 + 3] = 0.0f;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int composite_fwd(const int* counts, const float* records,
                             const float* colors, float* acc, float* tfin,
                             float* tst, int* nexec, int num_tiles, int K,
                             int tile_h, int tile_w, void* stream) {
  const int P = tile_h * tile_w;
  composite_fwd_kernel<<<num_tiles, P, 0, (cudaStream_t)stream>>>(
      counts, records, colors, acc, tfin, tst, nexec, K, tile_h, tile_w);
  return (int)cudaGetLastError();
}
