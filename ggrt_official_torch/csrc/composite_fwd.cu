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
// alpha = opacity·exp(-(u² + v²)/2). Alpha below 1/255 is skipped and alpha
// is clamped at 0.99. The TPU kernel's per-chunk rule: within a chunk a
// pixel takes Gaussians in order while T·(1 - alpha) stays ≥ 1e-4 and stops
// at the first one that would take it below; that ends only this chunk.
// The next chunk starts again from the last contributing T, so a pixel that
// saturated may take small-alpha Gaussians later. T never falls below 1e-4,
// so the TPU kernel's "max T ≥ 1e-4" loop test always holds and every tile
// runs all ceil(count/128) chunks: nexec == that count.
//
// Design. One thread per pixel; a tile's warps (composite_cull.cuh's thread
// map, 32 for an 8×128 tile) are cut into blocks of 8 warps, so an 8×128
// tile takes 4 blocks and five blocks share an SM (48 registers a thread):
// 160 tiles make 640 blocks, one wave on 132 SMs, where one 1024-thread
// block per tile made 1.2 waves. Pixels are independent, so the blocks of a
// tile exchange nothing. Per 128-Gaussian chunk the block stages the
// chunk in shared memory, one thread per Gaussian: (l00, l01, cu, l11),
// (cv, opacity, r, g) and b, so that a walk reads a Gaussian with three
// broadcast loads, and the Gaussian's widened footprint box. Each warp then
// tests the 128 boxes against its own pixel rectangle (lane l takes
// Gaussians l, l+32, l+64, l+96; four __ballot_sync masks) and walks only
// the set bits, in order (__ffs), with a running product for T; a warp
// leaves the chunk after a mask word in which all its pixels stopped. A
// dropped Gaussian is one that every pixel of the warp would have skipped
// at alpha < 1/255, so each pixel does the same operations in the same
// order as a one-block-per-tile kernel that walks every Gaussian: the
// outputs do not depend on the culling or the thread map. The roundings
// of u, v, u² + v² and the colour sums are spelled out (evaluate in
// composite_cull.cuh, __fmaf_rn below), so that they do not depend on how
// the compiler contracts either; they are those of the earlier
// one-block-per-tile kernel as nvcc compiled it.
//
// Bound. fp32 ALU and SFU (exp) throughput: about 21 operations per live
// (pixel, Gaussian) pair of the executed chunks, one with alpha ≥ 1/255
// before the pixel's cut at T < 1e-4 in the chunk, or the bytes where those
// are fewer: record rows 0-5 and colour rows 0-2 of the executed chunks
// read, acc, tfin, tst and nexec written, about 14 MB at the full-width
// render (160 tiles of 8×128, K = 1024), ~4.3 µs at 3.35 TB/s.
// chip_smoke.py prints both counts. What keeps the kernel above
// that bound: every kept (warp, Gaussian) pair is evaluated on all 32
// lanes, several times the live pairs where footprints are pixel-scale;
// an evaluation costs some 40 instructions (expf's range reduction, the
// mask walk, the branches), not 21 operations at the FMA rate; and the
// block waits at each chunk's barriers for its busiest warp.

#include <cuda_runtime.h>

#include "composite_cull.cuh"

namespace {

using namespace composite;

__global__ void __launch_bounds__(kBlock) composite_fwd_kernel(
    const int* __restrict__ counts, const float* __restrict__ records,
    const float* __restrict__ colors, float* __restrict__ acc,
    float* __restrict__ tfin, float* __restrict__ tst, int* __restrict__ nexec,
    int K, TileMap m) {
  __shared__ Chunk s;

  const int t = blockIdx.x / m.blocks_per_tile;
  const int P = m.tile_h * m.tile_w;
  const int nch = K / kChunk;
  const int lane = threadIdx.x & 31;
  const int w = (blockIdx.x % m.blocks_per_tile) * m.warps_per_block + threadIdx.x / 32;
  const int p = lane_pixel(m, w, lane);
  const bool has_pixel = p >= 0;

  const int pp = has_pixel ? p : 0;
  const float px = (float)(pp % m.tile_w) - (m.tile_w - 1) * 0.5f;
  const float py = (float)(pp / m.tile_w) - (m.tile_h - 1) * 0.5f;
  const Rect rect = warp_rect(has_pixel, px, py);
  const float ext_x = (m.tile_w - 1) * 0.5f, ext_y = (m.tile_h - 1) * 0.5f;

  const int count = max(counts[t], 0);
  const int need = min((count + kChunk - 1) / kChunk, nch);

  const float* rec_t = records + (size_t)t * 8 * K;
  const float* col_t = colors + (size_t)t * 4 * K;
  float* tst_p = tst + ((size_t)t * P + pp) * nch;

  float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  for (int c = 0; c < need; ++c) {
    // Keeps the previous chunk's readers ahead of the staging below.
    __syncthreads();
    stage_chunk(rec_t, col_t, K, c * kChunk, s, ext_x, ext_y);
    __syncthreads();
    unsigned masks[4];
    warp_masks(s.box, rect, lane, masks);
    if (has_pixel) tst_p[c] = T;
    bool done = !has_pixel;  // this chunk only
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      for (unsigned mq = masks[q]; mq; mq &= mq - 1) {
        const int j = 32 * q + __ffs(mq) - 1;
        if (done) continue;
        const float4 gb = s.mix[j];
        const float araw = gb.y * evaluate(px, py, s.geo[j], gb.x).e;
        if (!(araw >= kAlphaMin)) continue;  // NaN skips too, as in the TPU kernel
        const float alpha = fminf(araw, kAlphaMax);
        const float T_next = T * (1.0f - alpha);
        if (T_next < kTEps) {
          done = true;  // ends this chunk only
          continue;
        }
        const float wgt = alpha * T;
        r = __fmaf_rn(wgt, gb.z, r);
        g = __fmaf_rn(wgt, gb.w, g);
        b = __fmaf_rn(wgt, s.blue[j], b);
        T = T_next;
      }
      if (__all_sync(kFull, done)) break;  // the warp leaves the chunk
    }
  }

  if (w == 0 && lane == 0) nexec[t] = need;
  if (has_pixel) {
    for (int cc = need; cc < nch; ++cc) tst_p[cc] = 1.0f;
    const size_t q = (size_t)t * P + pp;
    tfin[q] = T;
    reinterpret_cast<float4*>(acc)[q] = make_float4(r, g, b, 0.0f);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int composite_fwd(const int* counts, const float* records,
                             const float* colors, float* acc, float* tfin,
                             float* tst, int* nexec, int num_tiles, int K,
                             int tile_h, int tile_w, void* stream) {
  const TileMap m = tile_map(tile_h, tile_w);
  composite_fwd_kernel<<<num_tiles * m.blocks_per_tile, 32 * m.warps_per_block,
                         0, (cudaStream_t)stream>>>(counts, records, colors, acc,
                                                   tfin, tst, nexec, K, m);
  return (int)cudaGetLastError();
}
