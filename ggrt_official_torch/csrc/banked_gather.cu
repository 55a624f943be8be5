// Banked binning's per-tile lists in one launch: for every tile, the S slot
// windows of the (group, depth)-sorted key and payload streams are staged in
// shared memory, masked to their valid runs, and merged by rank into the
// tile's front-K Gaussian ids.
//
// Replaces the TPU kernel ggrt_official_tpu/ops/rasterizer/banked_gather.py
// ::_make_kernel.<kernel> (launched by gather_streams) AND the flat sort that
// follows it in ggrt_official_tpu/ops/rasterizer/tiling.py (the "flat" merge
// of bin_gaussians_banked: one global two-key sort of every tile's window
// columns, then the front-K cut). The flat sort is a TPU workaround: XLA ran
// the per-tile two-key sort ~6x slower per element. On the card a tile's
// whole candidate set fits in one block's shared memory, so the merge is
// done there and the (T, ncol) intermediates never reach device memory.
//
//   key  (n,)      int32  group << qbits | q, sorted by (group, q), stable
//   gw   (n,)      int32  gid | (nxw | nyw << 2) << 25
//   al, lo, hi  (T, S) int32  window start / 128 and the valid run [lo, hi)
//   ids    (T, K)  int64  front to back, -1 past the count
//   counts (T,)    int32  min(n_valid, K)
// Column j < budget_s + 128 of slot s of tile t reads pos = al·128 + j and is
//   valid = 0 <= pos < n && lo <= pos < hi && dy < nyw && dx < nxw
// (win = gw >> 25 as unsigned, nxw = win & 3, nyw = win >> 2).
//
// Why a merge needs no sort. The streams are sorted stably by
// (group << qbits | q), so a group's run increases in (q, gid); a slot's
// valid entries are a subsequence of one group's run, so each slot gives a
// sorted run; the S slots of a tile read S different groups, so no gid
// appears twice in a tile and the keys q << 31 | gid are unique. The flat
// sort orders each tile's valid entries by exactly that key (the sentinels
// sort behind them). So the tile's list is the merge of S sorted runs with
// unique keys, and entry i of run s has the rank
//   i + Σ_{s' != s} #{entries of run s' below it}   (a lower bound each),
// independent of any order of work: the result is deterministic and equals
// the flat sort's bit for bit.
//
// Design. One 256-thread block per tile.
//  1. Thread s loads al/lo/hi[t, s]; the slot table (width, column offset,
//     dy, dx) is a kernel parameter, so no load waits on another.
//  2. One thread issues two bulk asynchronous copies per slot (key window
//     and payload window, (budget + 128)·4 bytes from byte al·512) into
//     shared memory; they complete on one mbarrier whose transaction count
//     is the bytes of all of them. A window that reaches past n is read by
//     guarded loads instead (no host look at al).
//  3. Warp w compacts slots w, w + 8, ...: over the run's span of the
//     window, 32 columns at a time, a ballot of the validity rule and a
//     popcount place each valid entry, in order, in the slot's run of keys
//     q << 31 | gid (uint64) in shared memory.
//  4. Each valid entry with i < K (an entry at i >= K has rank >= K) binary-
//     searches the other runs and stops once its rank reaches K; rank < K
//     goes to a shared row, which the block then writes out coalesced with
//     the -1 fill.
// Bound. Bytes: the key/payload words that some run [lo, hi) covers (the
// lists depend on nothing else of the windows), the descriptors, ids and
// counts written (chip_smoke.banked_lists_work). The searches set the
// pace: ~2100 valid entries a tile at 320x448 (~850 at
// 640x960), each searching 7 runs in ~10 dependent steps, on 160 blocks
// (640) that leave most SMs one block (five) of 8 warps. A pairwise
// merge-path tree of the runs would cut the work to a few passes over the
// entries.
//
// Shared memory per block: 1024 + 16·ncol bytes (a header, the raw windows
// 8·ncol, the runs 8·ncol since a run holds at most its window),
// ncol = Σ (budget + 128). The caller gates it at 232,448 bytes
// (banked_gather.smem_bytes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAlign = 128;
constexpr int kMaxSlots = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeader = 1024;
constexpr unsigned kGidMask = (1u << 25) - 1u;
constexpr int kInvalidGid = 0x7FFFFFFF;

struct Slots {
  int S;
  int ncol;                  // Σ width
  int width[kMaxSlots];      // budget + 128 columns
  int off[kMaxSlots];        // the slot's first column (and run start)
  int dy[kMaxSlots];
  int dx[kMaxSlots];
};

struct Header {
  unsigned long long bar;    // the copies' mbarrier
  int al[kMaxSlots];
  int lo[kMaxSlots];
  int hi[kMaxSlots];
  int run_len[kMaxSlots];
};
static_assert(sizeof(Header) <= kHeader, "header does not fit");

// Entries of the sorted run a[0, len) below x.
__device__ __forceinline__ int count_below(const unsigned long long* a, int len,
                                           unsigned long long x) {
  int lo = 0;
  while (len > 0) {
    const int half = len >> 1;
    if (a[lo + half] < x) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo;
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__global__ void __launch_bounds__(kThreads, 5)
banked_lists_kernel(const int* __restrict__ key, const int* __restrict__ gw,
                    const int* __restrict__ al, const int* __restrict__ lo,
                    const int* __restrict__ hi, long long* __restrict__ ids,
                    int* __restrict__ counts, long long n, int K, int qbits,
                    const __grid_constant__ Slots p) {
  extern __shared__ __align__(128) unsigned char smem[];
  Header& h = *reinterpret_cast<Header*>(smem);
  int* raw_key = reinterpret_cast<int*>(smem + kHeader);
  int* raw_gw = raw_key + p.ncol;
  unsigned long long* run = reinterpret_cast<unsigned long long*>(raw_gw + p.ncol);
  int* out = raw_key;        // the merged row, once the windows are read

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned bar = (unsigned)__cvta_generic_to_shared(&h.bar);

  // 1. descriptors and the barrier
  if (tid < p.S) {
    const long long d = (long long)t * p.S + tid;
    h.al[tid] = al[d];
    h.lo[tid] = lo[d];
    h.hi[tid] = hi[d];
  }
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // 2. stage the windows: bulk copies where the window lies inside the
  // streams, guarded loads where it does not.
  auto inside = [&](int s) {
    const long long start = (long long)h.al[s] * kAlign;
    return start >= 0 && start + p.width[s] <= n;
  };
  if (tid == 0) {
    unsigned bytes = 0;
    for (int s = 0; s < p.S; ++s)
      if (inside(s)) bytes += 8u * (unsigned)p.width[s];
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
    for (int s = 0; s < p.S; ++s) {
      if (!inside(s)) continue;
      const long long start = (long long)h.al[s] * kAlign;
      const unsigned b = 4u * (unsigned)p.width[s];
      bulk_copy(raw_key + p.off[s], key + start, b, bar);
      bulk_copy(raw_gw + p.off[s], gw + start, b, bar);
    }
  }
  for (int s = 0; s < p.S; ++s) {
    if (inside(s)) continue;
    const long long start = (long long)h.al[s] * kAlign;
    for (int j = tid; j < p.width[s]; j += kThreads) {
      const long long pos = start + j;
      const bool in = pos >= 0 && pos < n;
      raw_key[p.off[s] + j] = in ? key[pos] : 0;
      raw_gw[p.off[s] + j] = in ? gw[pos] : kInvalidGid;
    }
  }
  mbar_wait(bar, 0);
  __syncthreads();

  // 3. compact: warp w walks slots w, w + kWarps, ...: one ballot of the
  // validity rule per 32 columns of the run's span, the valid entries in
  // order as q << 31 | gid.
  const unsigned qmask = (1u << qbits) - 1u;
  for (int s = warp; s < p.S; s += kWarps) {
    const long long start = (long long)h.al[s] * kAlign;
    const long long lo_s = h.lo[s], hi_s = h.hi[s];
    const unsigned dy = (unsigned)p.dy[s], dx = (unsigned)p.dx[s];
    const int* kw = raw_key + p.off[s];
    const int* ww = raw_gw + p.off[s];
    unsigned long long* r = run + p.off[s];
    const long long first = lo_s - start > 0 ? lo_s - start : 0;
    const long long end = hi_s - start < p.width[s] ? hi_s - start : p.width[s];
    int n_s = 0;
    for (long long j0 = first & ~31LL; j0 < end; j0 += 32) {
      const int j = (int)j0 + lane;
      const long long pos = start + j;
      const unsigned w = (unsigned)ww[j];
      const unsigned win = w >> 25;
      const bool valid = pos >= 0 && pos < n && pos >= lo_s && pos < hi_s &&
                         dy < (win >> 2) && dx < (win & 3u);
      const unsigned m = __ballot_sync(0xFFFFFFFFu, valid);
      if (valid)
        r[n_s + __popc(m & ((1u << lane) - 1u))] =
            ((unsigned long long)((unsigned)kw[j] & qmask) << 31) | (w & kGidMask);
      n_s += __popc(m);
    }
    if (lane == 0) h.run_len[s] = n_s;
  }
  __syncthreads();

  // 4. rank merge into the shared row.
  int n_valid = 0;
  for (int s = 0; s < p.S; ++s) n_valid += h.run_len[s];
  const int count = min(n_valid, K);
  for (int s = 0; s < p.S; ++s) {
    const int len = min(h.run_len[s], K);
    const unsigned long long* a = run + p.off[s];
    for (int i = tid; i < len; i += kThreads) {
      const unsigned long long x = a[i];
      int rank = i;
      for (int s2 = 0; s2 < p.S && rank < K; ++s2)
        if (s2 != s) rank += count_below(run + p.off[s2], h.run_len[s2], x);
      if (rank < K) out[rank] = (int)(x & kGidMask);
    }
  }
  __syncthreads();

  long long* row = ids + (long long)t * K;
  for (int r = tid; r < K; r += kThreads) row[r] = r < count ? (long long)out[r] : -1LL;
  if (tid == 0) counts[t] = count;
}

}  // namespace

// slots: host array of 3·S ints, per slot (width, dy, dx); widths are
// multiples of 128. A block takes kHeader + 16·ncol bytes of shared memory.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int banked_lists(const int* key, const int* gw, const int* al, const int* lo,
                            const int* hi, long long* ids, int* counts, const int* slots,
                            long long n, int num_tiles, int S, int K, int qbits,
                            void* stream) {
  if (S <= 0 || S > kMaxSlots) return (int)cudaErrorInvalidValue;
  Slots p{};
  p.S = S;
  for (int s = 0; s < S; ++s) {
    p.width[s] = slots[3 * s];
    p.off[s] = p.ncol;
    p.dy[s] = slots[3 * s + 1];
    p.dx[s] = slots[3 * s + 2];
    p.ncol += p.width[s];
  }
  const int smem_bytes = kHeader + 16 * p.ncol;
  // Above 48 KB a block's dynamic shared memory must be allowed first.
  const cudaError_t e = cudaFuncSetAttribute(
      banked_lists_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (num_tiles > 0) {
    banked_lists_kernel<<<num_tiles, kThreads, smem_bytes, (cudaStream_t)stream>>>(
        key, gw, al, lo, hi, ids, counts, n, K, qbits, p);
  }
  return (int)cudaGetLastError();
}
