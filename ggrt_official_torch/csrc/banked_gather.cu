// Banked binning's stream gather: for every (tile, slot), one window of the
// (group, depth)-sorted key and payload arrays, masked to the valid run and
// the window shape, written as the flat merge sort's inputs.
//
// Replaces the TPU kernel ggrt_official_tpu/ops/rasterizer/banked_gather.py
// ::_make_kernel.<kernel> (launched by gather_streams). The TPU kernel DMAs
// each slot's 128-aligned window into VMEM, one grid step per tile, because
// an XLA gather of these runs was latency-bound there. On the card the
// windows are plain coalesced reads.
//   key  (n,)      int32  group << qbits | q, sorted; padded past every window
//   gw   (n,)      int32  gid | (nxw | nyw << 2) << 25, INVALID_GID-padded
//   al, lo, hi  (T, S) int32  window start / 128 and the valid run [lo, hi)
//   slots (4, S)   int32  per slot: window width budget+128, output column
//                         offset, dy, dx
//   packed, gid  (T, ncol) int32, every column written
// For column j of slot s of tile t, pos = al·128 + j, and
//   valid  = lo <= pos < hi && dy < nyw && dx < nxw
//   packed = t << qbits | (valid ? key & qmask : qmask)
//   gid    = valid ? gw & (2^25 - 1) : INVALID_GID.
// The layout (window at al·128, 128 extra columns, sentinels) is the TPU
// kernel's, so the outputs equal its outputs bit for bit. Banked binning pads
// key and gw so that every window lies inside them; a position outside
// [0, n) is read as no entry (the sentinels), so the kernel never reads out
// of bounds and the wrapper needs no look at al on the host.
//
// Design. One block per (tile, slot); its threads stride over the window's
// columns, so neighbouring threads read neighbouring key/gw words and write
// neighbouring output words. Nothing is reused, so no shared memory. The
// payload is shifted as unsigned, as the TPU kernel's shift_right_logical.
//
// Bound. Bytes: the outputs, 8·T·ncol, written once, and the windows read
// (at most 8·T·ncol, less where windows of different tiles overlap). At
// 320x448 with 8x128 tiles and K = 1024 (T = 160, ncol = 4096) that is
// 5.2 MB of output, a few microseconds at 3.35 TB/s, near a launch's own
// latency.

#include <cuda_runtime.h>

namespace {

constexpr int kAlign = 128;
constexpr unsigned kGidMask = (1u << 25) - 1u;
constexpr int kInvalidGid = 0x7FFFFFFF;

__global__ void banked_gather_kernel(const int* __restrict__ key,
                                     const int* __restrict__ gw,
                                     const int* __restrict__ al,
                                     const int* __restrict__ lo,
                                     const int* __restrict__ hi,
                                     const int* __restrict__ slots,
                                     int* __restrict__ packed,
                                     int* __restrict__ gid, long long n, int S,
                                     int ncol, int qbits) {
  const int t = blockIdx.x;
  const int s = blockIdx.y;
  const int width = slots[s];
  const int off = slots[S + s];
  const unsigned dy = (unsigned)slots[2 * S + s];
  const unsigned dx = (unsigned)slots[3 * S + s];
  const long long d = (long long)t * S + s;
  const long long start = (long long)al[d] * kAlign;
  const long long run_lo = lo[d];
  const long long run_hi = hi[d];
  const unsigned qmask = (1u << qbits) - 1u;
  const unsigned tile_hi = (unsigned)t << qbits;
  int* __restrict__ pk_row = packed + (long long)t * ncol + off;
  int* __restrict__ gid_row = gid + (long long)t * ncol + off;

  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    const long long pos = start + j;
    const bool inside = pos >= 0 && pos < n;
    const unsigned k = inside ? (unsigned)key[pos] : 0u;
    const unsigned w = inside ? (unsigned)gw[pos] : (unsigned)kInvalidGid;
    const unsigned win = w >> 25;
    const bool valid = inside && pos >= run_lo && pos < run_hi &&
                       dy < (win >> 2) && dx < (win & 3u);
    pk_row[j] = (int)(tile_hi | (valid ? (k & qmask) : qmask));
    gid_row[j] = valid ? (int)(w & kGidMask) : kInvalidGid;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int banked_gather(const int* key, const int* gw, const int* al,
                             const int* lo, const int* hi, const int* slots,
                             int* packed, int* gid, long long n,
                             int num_tiles, int S, int ncol, int qbits,
                             void* stream) {
  if (num_tiles > 0 && S > 0) {
    const dim3 grid((unsigned)num_tiles, (unsigned)S);
    banked_gather_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        key, gw, al, lo, hi, slots, packed, gid, n, S, ncol, qbits);
  }
  return (int)cudaGetLastError();
}
