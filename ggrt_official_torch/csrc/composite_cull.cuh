// What the forward and backward compositor kernels share: constants, the
// map from a tile's threads to its pixels, the staging of a 128-Gaussian
// chunk, and the footprint test by which a warp skips the Gaussians that
// reach none of its pixels.
//
// Thread map. A tile of P = tile_h × tile_w ≤ 1024 pixels gets one thread
// per pixel; warp w takes a pw × ph patch (ph = 8, or the largest power of
// two ≤ tile_h; pw = 32/ph), patches in row-major order: 4 columns × 8 rows
// of an 8×128 tile, so that a pixel-scale Gaussian meets few warps (fewer
// than with 32×1 row strips, which measured slower at every record set of
// chip_smoke.py). Lanes past the tile's edge hold no pixel. The warps are cut
// into blocks of at most kWarpsPerBlock (several blocks per tile).
// cuda_composite.warp_pixels builds the same map on tensors.
//
// Footprint test. alpha = op·exp(-(u²+v²)/2) ≥ 1/255 needs u²+v² ≤ r² with
// r² = 2·ln(255·op). With L = [[l00, l01], [0, l11]] and (u, v) = L·(x, y)
// + (cu, cv), that ellipse is μ + L⁻¹·disk(r), centred at
// μ = (-(cu + l01·μy)/l00, -cv/l11) and bounded by the axis-aligned box of
// half-widths r·|row of L⁻¹| = r·√(1 + (l01/l11)²)/|l00| and r/|l11|. The
// box is widened for float32 rounding:
//   - r by 4e-3·(r + 1), which covers expf's and logf's few ulps and the
//     product op·e (at r → 0 a relative error of 1e-6 in alpha moves r by
//     ~1e-3), and by 1e-6 of |l00|·x̂ + |l01|·ŷ + |cu| + |l11|·ŷ + |cv|
//     (x̂, ŷ the tile's largest |x|, |y|), four times the rounding of the
//     kernel's u and v;
//   - each half-width by one pixel, and by 2^-16 of the magnitudes that go
//     into μ and the half-width (the box's own rounding).
// A warp keeps Gaussian j unless the box misses the warp's pixel rectangle.
// Opacity below 1/255 (or NaN) and a non-finite l00, l01, cu, l11 or cv
// give an empty box: araw = op·e with e ≤ 1 stays below 1/255, and
// non-finite geometry makes u² + v² infinite or NaN at every pixel, so
// araw is 0 or NaN. Opacity +inf gives an infinite box (the kernels, like
// the plain version, clamp its alpha to 0.99). Every other NaN in the box
// fails the miss test and keeps the Gaussian. A dropped Gaussian is one
// that every pixel of the warp would have skipped, so each pixel does the
// same operations in the same order as without the test.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace composite {

constexpr int kChunk = 128;
constexpr int kWarpsPerBlock = 8;
constexpr int kBlock = 32 * kWarpsPerBlock;
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kRel = 1.0f / 65536.0f;

struct TileMap {
  int tile_h, tile_w;
  int pw, ph, npx;  // patch width, height, patches across
  int warps;        // warps per tile
  int warps_per_block, blocks_per_tile;
};

inline __host__ __device__ TileMap tile_map(int tile_h, int tile_w) {
  TileMap m;
  m.tile_h = tile_h;
  m.tile_w = tile_w;
  m.ph = tile_h >= 8 ? 8 : tile_h >= 4 ? 4 : tile_h >= 2 ? 2 : 1;
  m.pw = 32 / m.ph;
  m.npx = (tile_w + m.pw - 1) / m.pw;
  m.warps = m.npx * ((tile_h + m.ph - 1) / m.ph);
  m.warps_per_block = m.warps < kWarpsPerBlock ? m.warps : kWarpsPerBlock;
  m.blocks_per_tile = (m.warps + m.warps_per_block - 1) / m.warps_per_block;
  return m;
}

// The pixel of lane `lane` of the tile's warp `w`, or -1.
inline __device__ int lane_pixel(const TileMap& m, int w, int lane) {
  const int x = (w % m.npx) * m.pw + lane % m.pw;
  const int y = (w / m.npx) * m.ph + lane / m.pw;
  return (w < m.warps && x < m.tile_w && y < m.tile_h) ? y * m.tile_w + x : -1;
}

// u, v and exp(-(u² + v²)/2) of one Gaussian at pixel (px, py), from
// geo = (l00, l01, cu, l11) and cv. The roundings are spelled out, so that
// the result does not depend on how the compiler contracts products into
// FMAs: u = fma(px, l00, py·l01) + cu, v = fma(py, l11, cv) and
// u² + v² = fma(u, u, v·v).
struct Eval {
  float u, v, e;
};

inline __device__ Eval evaluate(float px, float py, float4 geo, float cv) {
  const float u = __fadd_rn(__fmaf_rn(px, geo.x, __fmul_rn(py, geo.y)), geo.z);
  const float v = __fmaf_rn(py, geo.w, cv);
  return {u, v, expf(-0.5f * __fmaf_rn(u, u, __fmul_rn(v, v)))};
}

// The warp's pixel rectangle [x0, x1] × [y0, y1] in tile-centred
// coordinates; empty (x0 = +inf) for a warp without pixels.
struct Rect {
  float x0, x1, y0, y1;
};

inline __device__ Rect warp_rect(bool has_pixel, float px, float py) {
  Rect r{has_pixel ? px : CUDART_INF_F, has_pixel ? px : -CUDART_INF_F,
         has_pixel ? py : CUDART_INF_F, has_pixel ? py : -CUDART_INF_F};
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    r.x0 = fminf(r.x0, __shfl_xor_sync(kFull, r.x0, o));
    r.x1 = fmaxf(r.x1, __shfl_xor_sync(kFull, r.x1, o));
    r.y0 = fminf(r.y0, __shfl_xor_sync(kFull, r.y0, o));
    r.y1 = fmaxf(r.y1, __shfl_xor_sync(kFull, r.y1, o));
  }
  return r;
}

// The widened footprint box (xlo, xhi, ylo, yhi) of one record; see above.
inline __device__ float4 footprint_box(float l00, float l01, float cu, float l11,
                                       float cv, float op, float ext_x,
                                       float ext_y) {
  const float4 none =
      make_float4(CUDART_INF_F, -CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F);
  if (!(op >= kAlphaMin)) return none;
  // |x| < inf is false for ±inf and NaN.
  if (!(fabsf(l00) < CUDART_INF_F && fabsf(l01) < CUDART_INF_F &&
        fabsf(cu) < CUDART_INF_F && fabsf(l11) < CUDART_INF_F &&
        fabsf(cv) < CUDART_INF_F))
    return none;
  const float r = sqrtf(fmaxf(2.0f * logf(255.0f * op), 0.0f));
  const float R = r + 4e-3f * (r + 1.0f) +
                  1e-6f * (fabsf(l00) * ext_x + fabsf(l01) * ext_y + fabsf(cu) +
                           fabsf(l11) * ext_y + fabsf(cv));
  const float iy = 1.0f / l11;
  const float my = -cv * iy;
  const float a = l01 * iy;
  const float mx = -(cu + l01 * my) / l00;
  const float hx0 = R * sqrtf(1.0f + a * a) / fabsf(l00);
  const float hy0 = R * fabsf(iy);
  const float hx =
      hx0 + 1.0f +
      kRel * (fabsf(mx) + hx0 + (fabsf(cu) + fabsf(l01 * my)) / fabsf(l00));
  const float hy = hy0 + 1.0f + kRel * (fabsf(my) + hy0);
  return make_float4(mx - hx, mx + hx, my - hy, my + hy);
}

// Whether the box reaches the rectangle; NaN anywhere keeps the Gaussian.
inline __device__ bool box_meets(float4 b, const Rect& r) {
  return !(b.x > r.x1 || b.y < r.x0 || b.z > r.y1 || b.w < r.y0);
}

// One staged chunk in shared memory: per Gaussian (l00, l01, cu, l11),
// (cv, opacity, r, g), b and the footprint box, so that a walk reads a
// Gaussian with three broadcast loads.
struct Chunk {
  float4 geo[kChunk];
  float4 mix[kChunk];
  float blue[kChunk];
  float4 box[kChunk];
};

// Stage chunk `off` of one tile. A thread takes whole Gaussians: it reads
// the six record and three colour entries (neighbouring threads read
// neighbouring floats of each 512-byte row) and forms the box from them.
inline __device__ void stage_chunk(const float* __restrict__ rec_t,
                                   const float* __restrict__ col_t, int K,
                                   int off, Chunk& s, float ext_x, float ext_y) {
  const size_t k1 = K;
  for (int k = threadIdx.x; k < kChunk; k += blockDim.x) {
    const float* r = rec_t + off + k;
    const float* c = col_t + off + k;
    const float l00 = r[0], l01 = r[k1], cu = r[2 * k1], l11 = r[3 * k1];
    const float cv = r[4 * k1], op = r[5 * k1];
    s.geo[k] = make_float4(l00, l01, cu, l11);
    s.mix[k] = make_float4(cv, op, c[0], c[k1]);
    s.blue[k] = c[2 * k1];
    s.box[k] = footprint_box(l00, l01, cu, l11, cv, op, ext_x, ext_y);
  }
}

// The warp's four masks of chunk Gaussians that may reach its pixels: bit l
// of masks[q] is Gaussian 32q + l, tested by lane l.
inline __device__ void warp_masks(const float4* s_box, const Rect& rect,
                                  int lane, unsigned masks[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    masks[q] = __ballot_sync(kFull, box_meets(s_box[32 * q + lane], rect));
}

}  // namespace composite
