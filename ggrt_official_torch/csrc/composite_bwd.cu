// Backward of the per-tile alpha compositor: d(records), d(colors) from
// d(acc) and d(tfin).
//
// Replaces the TPU kernel ggrt_official_tpu/ops/rasterizer/pallas_composite.py
// ::_bwd_kernel (launched by _bwd_raw). Same inputs and outputs:
//   nexec   (t,)          int32   chunks the forward executed
//   records (t, 8, K)     float32 rows [l00, l01, cu, l11, cv, opacity, 0, 0]
//   colors  (t, 4, K)     float32 rows [r, g, b, 0]
//   tst     (t, P, K/128) float32 transmittance at the start of each chunk
//   tfin    (t, P, 1)     float32 final transmittance
//   gout    (t, P, 4)     float32 d(acc); channel 3 is ignored
//   gtfin   (t, P, 1)     float32 d(tfin)
//   drec    (t, 8, K)     float32 rows 0-5 added to; rows 6-7 stay as given
//   dcol    (t, 4, K)     float32 rows 0-2 added to; row 3 stays as given
// The wrapper passes drec and dcol zeroed; chunks at or past nexec are not
// touched and stay zero, as in the TPU kernel.
//
// Per executed chunk, back to front, with T_start = tst[c] and the forward's
// per-chunk rule (a Gaussian contributes while TT = T_start·Π(1-α) ≥ 1e-4):
//   w      = α·Tb where Tb is T before the Gaussian, 0 past the cut
//   dwdot  = Σ_c dacc_c·C_c          dcol_c += Σ_p dacc_c·w
//   dα     = dwdot·Tb - (suffix + accum + dtfin·tfin)/(1-α)
// where suffix is Σ dwdot·w over the chunk's later Gaussians and accum the
// same sum over all later chunks. dα is gated to 1/255 ≤ araw < 0.99 and
// chained through araw = op·exp(-(u²+v²)/2) to dl00, dl01, dcu, dl11, dcv
// and dop.
//
// Design. The forward's blocks, staging and culling (composite_cull.cuh):
// one thread per pixel, blocks of 8 warps, 4 blocks per 8×128 tile, and
// each warp walks only the Gaussians whose box meets its pixel rectangle,
// in both passes. The per-pixel suffix is taken in two passes over the
// chunk: the first walks it with the running product for T and sums
// dwdot·w; the second walks it again and takes suffix = total - prefix.
// That subtraction costs a few float32 ulps of the chunk total, so the
// kernel agrees with the plain version (which takes the suffix by cumsum)
// to about 1e-6 of the largest per-chunk sum, not bit for bit. Reductions:
// for each kept Gaussian that some lane of the warp takes (one __any_sync:
// the box keeps more pairs than reach alpha ≥ 1/255, and a skipped
// reduction leaves zeros), the warp sums its nine per-pixel terms over its
// lanes by a reduce-scatter (shuffles at offsets 16, 8 and 4 halve the
// eight geometry and colour terms a lane carries, then 2 and 1 finish each
// sum: 9 shuffles, and 5 for the ninth term, against 45 for nine separate
// sums), and writes them to its own (9, 128) rows in shared memory: no two
// warps write one address. After the chunk the block sums its warps' rows,
// and one float atomicAdd per non-zero entry adds the block's partial to
// drec/dcol. Atomics rather than (t, blocks, 9, K) partials and a second
// kernel: at most 4 adds per entry, no scratch and one launch. The order of the adds varies from run
// to run: the result is reproducible to float32 rounding, not bitwise.
//
// Bound. fp32 ALU and SFU: about 61 operations per live (pixel, Gaussian)
// pair of the executed chunks (alpha ≥ 1/255 before the pixel's cut): both
// passes' u, v, exp, w and dwdot, d(alpha) and its chain, and the nine sums
// over pixels; or the bytes where those are fewer (of the executed chunks,
// record rows 0-5, colour rows 0-2 and tst read and the nine gradient rows
// written; tfin, three gout channels and gtfin: ~20 MB at the full-width
// render, ~6.1 µs at 3.35 TB/s). chip_smoke.py prints both counts. What keeps the kernel above that bound: the forward's reasons
// (every kept pair evaluated on 32 lanes, ~40 instructions an evaluation,
// the barriers), twice over, and the reduction, ~30 instructions a kept
// (warp, Gaussian) pair that some lane takes.

#include <cuda_runtime.h>

#include "composite_cull.cuh"

namespace {

using namespace composite;

constexpr int kAccStride = kChunk + 1;  // rows of 129: the 9 writers hit 9 banks

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Sum g[0..7] over the warp: lanes 4k .. 4k+3 end with the sum of g[k].
__device__ __forceinline__ float warp_reduce_scatter8(const float g[8], int lane) {
  float a[4], b[2];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = (b4 ? g[i + 4] : g[i]) + __shfl_xor_sync(kFull, b4 ? g[i] : g[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    b[i] = (b3 ? a[i + 2] : a[i]) + __shfl_xor_sync(kFull, b3 ? a[i] : a[i + 2], 8);
  float s = (b2 ? b[1] : b[0]) + __shfl_xor_sync(kFull, b2 ? b[0] : b[1], 4);
  s += __shfl_xor_sync(kFull, s, 2);
  s += __shfl_xor_sync(kFull, s, 1);
  return s;
}

__global__ void __launch_bounds__(kBlock) composite_bwd_kernel(
    const int* __restrict__ nexec, const float* __restrict__ records,
    const float* __restrict__ colors, const float* __restrict__ tst,
    const float* __restrict__ tfin, const float* __restrict__ gout,
    const float* __restrict__ gtfin, float* __restrict__ drec,
    float* __restrict__ dcol, int K, TileMap m) {
  __shared__ Chunk s;
  // Per warp: dl00 dl01 dcu dl11 dcv dop dr dg db of each chunk Gaussian.
  __shared__ float s_wacc[kWarpsPerBlock][9 * kAccStride];

  const int t = blockIdx.x / m.blocks_per_tile;
  const int P = m.tile_h * m.tile_w;
  const int nch = K / kChunk;
  const int lane = threadIdx.x & 31;
  const int wi = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  const int w = (blockIdx.x % m.blocks_per_tile) * m.warps_per_block + wi;
  const int p = lane_pixel(m, w, lane);
  const bool has_pixel = p >= 0;

  const int pp = has_pixel ? p : 0;
  const float px = (float)(pp % m.tile_w) - (m.tile_w - 1) * 0.5f;
  const float py = (float)(pp / m.tile_w) - (m.tile_h - 1) * 0.5f;
  const Rect rect = warp_rect(has_pixel, px, py);
  const float ext_x = (m.tile_w - 1) * 0.5f, ext_y = (m.tile_h - 1) * 0.5f;

  const float* rec_t = records + (size_t)t * 8 * K;
  const float* col_t = colors + (size_t)t * 4 * K;
  const size_t q = (size_t)t * P + pp;

  float dr = 0.f, dg = 0.f, db = 0.f, bg = 0.f;
  if (has_pixel) {
    const float4 go = reinterpret_cast<const float4*>(gout)[q];
    dr = go.x;
    dg = go.y;
    db = go.z;
    bg = gtfin[q] * tfin[q];
  }
  float accum = 0.f;
  float* acc_w = s_wacc[wi];

  const int n = min(nexec[t], nch);
  for (int c = n - 1; c >= 0; --c) {
    __syncthreads();  // the previous chunk's readers and writers are done
    const int off = c * kChunk;
    stage_chunk(rec_t, col_t, K, off, s, ext_x, ext_y);
    for (int i = lane; i < 9 * kAccStride; i += 32) acc_w[i] = 0.f;
    __syncthreads();
    unsigned masks[4];
    warp_masks(s.box, rect, lane, masks);

    const float T0 = has_pixel ? tst[q * nch + c] : 0.f;

    // Pass 1: the chunk's total of dwdot·w.
    float total = 0.f;
    {
      float T = T0;
      bool done = !has_pixel;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        for (unsigned mq = masks[qq]; mq; mq &= mq - 1) {
          const int j = 32 * qq + __ffs(mq) - 1;
          if (done) continue;
          const float4 gb = s.mix[j];
          const float araw = gb.y * evaluate(px, py, s.geo[j], gb.x).e;
          if (!(araw >= kAlphaMin)) continue;  // NaN skips too, as in the TPU kernel
          const float alpha = fminf(araw, kAlphaMax);
          const float TT = T * (1.0f - alpha);
          if (TT < kTEps) {
            done = true;
            continue;
          }
          const float dwdot = dr * gb.z + dg * gb.w + db * s.blue[j];
          total += dwdot * alpha * T;
          T = TT;
        }
        if (__all_sync(kFull, done)) break;
      }
    }

    // Pass 2: per-Gaussian gradients with suffix = total - prefix, summed
    // over the warp's lanes; a lane past its cut contributes zeros.
    {
      float T = T0, prefix = 0.f;
      bool done = !has_pixel;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        for (unsigned mq = masks[qq]; mq; mq &= mq - 1) {
          const int j = 32 * qq + __ffs(mq) - 1;
          float g[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          bool term = false;
          if (!done) {
            const float4 gb = s.mix[j];
            const Eval ev = evaluate(px, py, s.geo[j], gb.x);
            const float u = ev.u, v = ev.v, e = ev.e;
            const float araw = gb.y * e;
            if (araw >= kAlphaMin) {
              const float alpha = fminf(araw, kAlphaMax);
              const float om = 1.0f - alpha;
              const float TT = T * om;
              if (TT < kTEps) {
                done = true;
              } else {
                const float wgt = alpha * T;
                const float dwdot = dr * gb.z + dg * gb.w + db * s.blue[j];
                prefix += dwdot * wgt;
                const float suffix = total - prefix;
                g[6] = dr * wgt;
                g[7] = dg * wgt;
                g[8] = db * wgt;
                if (araw < kAlphaMax) {
                  const float dalpha = dwdot * T - (suffix + accum + bg) / om;
                  const float dq2 = dalpha * araw;
                  const float du = -u * dq2, dv = -v * dq2;
                  g[0] = du * px;
                  g[1] = du * py;
                  g[2] = du;
                  g[3] = dv * py;
                  g[4] = dv;
                  g[5] = dalpha * e;
                }
                term = true;
                T = TT;
              }
            }
          }
          if (__any_sync(kFull, term)) {  // the warp's nine sums, into its own rows
            const float part = warp_reduce_scatter8(g, lane);
            const float s8 = warp_sum(g[8]);
            if ((lane & 3) == 0) acc_w[(lane >> 2) * kAccStride + j] = part;
            if (lane == 0) acc_w[8 * kAccStride + j] = s8;
          }
        }
        if (__all_sync(kFull, done)) break;
      }
    }
    accum += total;
    __syncthreads();

    // The block's partial: its warps' rows summed, added to drec/dcol.
    float* drec_c = drec + (size_t)t * 8 * K + off;
    float* dcol_c = dcol + (size_t)t * 4 * K + off;
    for (int i = threadIdx.x; i < 9 * kChunk; i += blockDim.x) {
      const int row = i / kChunk, k = i % kChunk;
      float sum = 0.f;
      for (int v = 0; v < nwarps; ++v) sum += s_wacc[v][row * kAccStride + k];
      if (sum == 0.f) continue;
      atomicAdd(row < 6 ? drec_c + (size_t)row * K + k : dcol_c + (size_t)(row - 6) * K + k, sum);
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int composite_bwd(const int* nexec, const float* records,
                             const float* colors, const float* tst,
                             const float* tfin, const float* gout,
                             const float* gtfin, float* drec, float* dcol,
                             int num_tiles, int K, int tile_h, int tile_w,
                             void* stream) {
  const TileMap m = tile_map(tile_h, tile_w);
  composite_bwd_kernel<<<num_tiles * m.blocks_per_tile, 32 * m.warps_per_block,
                         0, (cudaStream_t)stream>>>(nexec, records, colors, tst,
                                                   tfin, gout, gtfin, drec, dcol,
                                                   K, m);
  return (int)cudaGetLastError();
}
