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
//   drec    (t, 8, K)     float32 rows 0-5 written; rows 6-7 stay as given
//   dcol    (t, 4, K)     float32 rows 0-2 written; row 3 stays as given
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
// Design. One block per tile, one thread per pixel (blockDim rounded up to a
// warp). The block stages a chunk's 9 used rows in shared memory. The
// per-pixel suffix is taken in two passes over the chunk: the first walks
// it with the running product for T and sums dwdot·w; the second walks it
// again and takes suffix = total - prefix. That subtraction costs a few
// float32 ulps of the chunk total, so the kernel agrees with the plain
// version (which takes the suffix by cumsum) to about 1e-6 of the largest
// per-chunk sum, not bit for bit. Each Gaussian's 9 gradients are sums over
// the tile's pixels: a warp reduces its 32 lanes by shuffles, but only when
// some lane has a non-zero term (a Gaussian covers a few warps of the
// tile), and lane 0 adds the warp's sum to a (9, 128) shared accumulator;
// one thread per entry writes it out after the chunk. Each tile owns its
// slice of drec/dcol, so no global atomics are needed. The order of the
// shared-memory adds across warps varies from run to run: the result is
// reproducible to float32 rounding, not bitwise.
//
// Bound. fp32 ALU and SFU: two evaluations of u, v and exp per (pixel,
// Gaussian) of the executed chunks, about 40 operations each, plus the warp
// reductions where a Gaussian touches the pixels. At the full-width render
// (160 tiles of 8×128, K = 1024, all 8 chunks executed) that is 168M
// evaluations, ~0.1 ms at 67 TFLOP/s; the bytes (records, colors, tst,
// gout, outputs: ~12 MB) take a few microseconds at 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// 1024 threads a block: the compiler keeps to 64 registers a thread.
__global__ void __launch_bounds__(1024) composite_bwd_kernel(
    const int* __restrict__ nexec, const float* __restrict__ records,
    const float* __restrict__ colors, const float* __restrict__ tst,
    const float* __restrict__ tfin, const float* __restrict__ gout,
    const float* __restrict__ gtfin, float* __restrict__ drec,
    float* __restrict__ dcol, int K, int tile_h, int tile_w) {
  __shared__ float s_rec[6][kChunk];
  __shared__ float s_col[3][kChunk];
  __shared__ float s_acc[9][kChunk];  // dl00 dl01 dcu dl11 dcv dop dr dg db

  const int t = blockIdx.x;
  const int P = tile_h * tile_w;
  const int nch = K / kChunk;
  const int p = threadIdx.x;
  const bool has_pixel = p < P;
  const int lane = threadIdx.x & 31;

  const float px = (float)(p % tile_w) - (tile_w - 1) * 0.5f;
  const float py = (float)(p / tile_w) - (tile_h - 1) * 0.5f;

  const float* rec_t = records + (size_t)t * 8 * K;
  const float* col_t = colors + (size_t)t * 4 * K;
  const size_t q = (size_t)t * P + p;

  float dr = 0.f, dg = 0.f, db = 0.f, bg = 0.f;
  if (has_pixel) {
    dr = gout[q * 4 + 0];
    dg = gout[q * 4 + 1];
    db = gout[q * 4 + 2];
    bg = gtfin[q] * tfin[q];
  }
  float accum = 0.f;

  const int n = min(nexec[t], nch);
  for (int c = n - 1; c >= 0; --c) {
    __syncthreads();  // the previous chunk's readers and writers are done
    const int off = c * kChunk;
    for (int i = threadIdx.x; i < 9 * kChunk; i += blockDim.x) {
      const int row = i / kChunk, k = i % kChunk;
      if (row < 6) {
        s_rec[row][k] = rec_t[(size_t)row * K + off + k];
      } else {
        s_col[row - 6][k] = col_t[(size_t)(row - 6) * K + off + k];
      }
      s_acc[row][k] = 0.f;
    }
    __syncthreads();

    const float T0 = has_pixel ? tst[q * nch + c] : 0.f;

    // Pass 1: the chunk's total of dwdot·w.
    float total = 0.f;
    if (has_pixel) {
      float T = T0;
      for (int j = 0; j < kChunk; ++j) {
        const float u = px * s_rec[0][j] + py * s_rec[1][j] + s_rec[2][j];
        const float v = py * s_rec[3][j] + s_rec[4][j];
        const float araw = s_rec[5][j] * expf(-0.5f * (u * u + v * v));
        if (!(araw >= kAlphaMin)) continue;  // NaN skips too, as in the TPU kernel
        const float alpha = fminf(araw, kAlphaMax);
        const float TT = T * (1.0f - alpha);
        if (TT < kTEps) break;
        const float dwdot = dr * s_col[0][j] + dg * s_col[1][j] + db * s_col[2][j];
        total += dwdot * alpha * T;
        T = TT;
      }
    }

    // Pass 2: per-Gaussian gradients with suffix = total - prefix. Every
    // lane walks all 128 Gaussians so that the warp's shuffles line up;
    // a lane past its cut contributes zeros.
    float T = T0, prefix = 0.f;
    bool done = !has_pixel;
    for (int j = 0; j < kChunk; ++j) {
      float g[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      bool any_term = false;
      if (!done) {
        const float u = px * s_rec[0][j] + py * s_rec[1][j] + s_rec[2][j];
        const float v = py * s_rec[3][j] + s_rec[4][j];
        const float e = expf(-0.5f * (u * u + v * v));
        const float araw = s_rec[5][j] * e;
        if (araw >= kAlphaMin) {
          const float alpha = fminf(araw, kAlphaMax);
          const float om = 1.0f - alpha;
          const float TT = T * om;
          if (TT < kTEps) {
            done = true;
          } else {
            const float w = alpha * T;
            const float dwdot = dr * s_col[0][j] + dg * s_col[1][j] + db * s_col[2][j];
            const float vj = dwdot * w;
            prefix += vj;
            const float suffix = total - prefix;
            g[6] = dr * w;
            g[7] = dg * w;
            g[8] = db * w;
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
            any_term = true;
            T = TT;
          }
        }
      }
      if (__any_sync(kFull, any_term)) {
#pragma unroll
        for (int r = 0; r < 9; ++r) {
          const float s = warp_sum(g[r]);
          if (lane == 0 && s != 0.f) atomicAdd(&s_acc[r][j], s);
        }
      }
      if (__all_sync(kFull, done)) break;
    }
    accum += total;
    __syncthreads();

    float* drec_c = drec + (size_t)t * 8 * K + off;
    float* dcol_c = dcol + (size_t)t * 4 * K + off;
    for (int i = threadIdx.x; i < 9 * kChunk; i += blockDim.x) {
      const int row = i / kChunk, k = i % kChunk;
      if (row < 6) {
        drec_c[(size_t)row * K + k] = s_acc[row][k];
      } else {
        dcol_c[(size_t)(row - 6) * K + k] = s_acc[row][k];
      }
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
  const int P = tile_h * tile_w;
  const int threads = (P + 31) / 32 * 32;
  composite_bwd_kernel<<<num_tiles, threads, 0, (cudaStream_t)stream>>>(
      nexec, records, colors, tst, tfin, gout, gtfin, drec, dcol, K, tile_h,
      tile_w);
  return (int)cudaGetLastError();
}
