// Phase 2 of the greedy NMS sweeps B1 (nms_sweep.cu) and B2
// (nms_sweep_iou.cu): the scan over a suppression bitmask.
//
// Mask layout, written by each source's phase 1: for problem b, a (K, W)
// array of 64-bit words, W = ceil(K / 64), at mask + b * K * W. Bit c of
// word w of row i is set iff j = 64 * w + c satisfies i < j < K and
// IoU(i, j) > thr. Only words w >= i / 64 are written (the diagonal word
// holds only the bits j > i); the words left of the diagonal are never read.
//
// Beside it, the summary: (B, K, ceil(W / 64)) words whose bit w of row i
// is set iff the mask's word w of row i is nonzero. The launch zeroes it and
// the mask pass sets it; the scan loads only the mask words it marks.
//
// The scan runs one block per problem. `removed` (W words in shared
// memory) starts as ~valid with the bits >= K set; keep = ~removed at the
// end. The 64-row tiles go in groups of 8 (512 rows, 8 words of `removed`,
// the group's window). For group g:
//
// - warp 0 resolves the group's 8 tiles in order. For tile t it resolves
//   the diagonal word serially in registers (lane r holds rows 64t + r and
//   64t + 32 + r; only the live rows whose diagonal word is nonzero enter
//   the chain, each costing one __ffsll and one __shfl_sync), then ORs the
//   kept rows' later words of the window into the window (in registers).
//   The group's rows are staged in shared memory, so no step waits on
//   device memory and only warp barriers are needed.
// - meanwhile warps 1-15 stage the next group's live rows (its window and
//   the one after) and OR the previous group's kept rows' words past this
//   window's end into `removed`, read from the mask in L2.
// - after a block barrier the block ORs the group's kept rows' words in the
//   next window (staged) into `removed`.
//
// What bounds it: warp 0's chain of about K / 64 tile steps (shared-memory
// round trips and warp reductions, plus one step per live row that
// suppresses a row of its own tile), or, where the kept rows' mask words
// are dense, the L2 reads one SM makes for them. The block meets twice a
// group, not twice a tile.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nms {

typedef unsigned long long u64;

constexpr int kTile = 64;
constexpr int kGroup = 8;                     // tiles a group, words a window
constexpr int kGroupRows = kTile * kGroup;    // 512
constexpr int kStaged = 2 * kGroup;           // staged words a row: two windows
constexpr int kStride = kStaged + 1;          // odd: no bank conflicts down a column
constexpr int kScanThreads = 512;
constexpr int kHelpers = kScanThreads - 32;   // warps 1-15
constexpr int kBatch = 16;                    // loads a helper has in flight
// The largest K the wrappers accept: a (K, K / 64) mask of 128 MB a problem.
constexpr int kMaxK = 32768;

__host__ __device__ inline int words(int k) { return (k + kTile - 1) / kTile; }
__host__ __device__ inline int summary_words(int nw) { return (nw + 63) / 64; }

// The workspace: the (B, K, W) mask, then the (B, K, ceil(W / 64))
// summary, whose bit w of row i is set iff the mask's word w of row i is
// nonzero (the launch zeroes it; the mask pass sets it).
inline u64* summary_of(u64* workspace, int batch, int k) {
  return workspace + (size_t)batch * k * words(k);
}
inline size_t summary_bytes(int batch, int k) {
  return (size_t)batch * k * summary_words(words(k)) * sizeof(u64);
}

// Mask pass: store word w of row i (b * K + i = `row`) and mark it in the
// summary if it is nonzero.
__device__ __forceinline__ void store_word(u64* __restrict__ mask, u64* __restrict__ sum,
                                           int nw, size_t row, int w, u64 word) {
  mask[row * nw + w] = word;
  if (word) atomicOr(sum + row * summary_words(nw) + w / 64, 1ull << (w % 64));
}

// Dynamic shared memory of the scan: `removed`, two groups of staged rows,
// two lists of kept rows.
inline size_t scan_smem_bytes(int nw) {
  return ((size_t)nw + 2 * kGroupRows * kStride) * sizeof(u64) + 2 * kGroupRows * sizeof(int);
}

__device__ __forceinline__ u64 or_across_warp(u64 x) {
  return (u64)__reduce_or_sync(~0u, (unsigned)x) |
         ((u64)__reduce_or_sync(~0u, (unsigned)(x >> 32)) << 32);
}

// Helpers (warps 1-15), one row each: stage the live rows of group g
// (words 8g .. 8g + 15 of rows 512g ..) into `buf` (row r, slot s at
// buf[r * kStride + s]). `gone` holds the group's tiles' words of `removed`
// as of the call: a removed row is not needed. Only the words the summary
// marks nonzero are loaded; the rest are stored as 0.
__device__ __forceinline__ void stage_group(const u64* __restrict__ m,
                                            const u64* __restrict__ sum, int k, int nw, int g,
                                            const u64* gone, u64* buf) {
  const int ns = summary_words(nw), w0 = g * kGroup;
  for (int r = threadIdx.x - 32; r < kGroupRows; r += kHelpers) {
    const int i = g * kGroupRows + r;
    unsigned bits = 0;  // words w0 .. w0 + 15 of row i that are nonzero
    if (i < k && !((gone[r / kTile] >> (r % kTile)) & 1)) {
      const u64* srow = sum + (size_t)i * ns;
      const int sw = w0 / 64, sb = w0 % 64;
      u64 x = srow[sw] >> sb;
      if (sb > 64 - kStaged && sw + 1 < ns) x |= srow[sw + 1] << (64 - sb);
      bits = (unsigned)(x & ((1ull << kStaged) - 1));
    }
    u64 vals[kStaged];
#pragma unroll
    for (int q = 0; q < kStaged; ++q)
      vals[q] = (bits >> q) & 1 ? m[(size_t)i * nw + w0 + q] : 0;
#pragma unroll
    for (int q = 0; q < kStaged; ++q) buf[r * kStride + q] = vals[q];
  }
}

// OR `x` into removed word `p` with two native 32-bit shared atomics.
__device__ __forceinline__ void atomic_or_words(u64* p, u64 x) {
  unsigned* h = reinterpret_cast<unsigned*>(p);
  if ((unsigned)x) atomicOr(h, (unsigned)x);
  if ((unsigned)(x >> 32)) atomicOr(h + 1, (unsigned)(x >> 32));
}

__global__ void __launch_bounds__(kScanThreads)
nms_sweep_scan_kernel(const u64* __restrict__ mask,     // (B, K, W)
                      const u64* __restrict__ summary,  // (B, K, ceil(W / 64))
                      const uint8_t* __restrict__ valid,  // (B, K) bool
                      int k,
                      uint8_t* __restrict__ keep) {       // (B, K) bool
  extern __shared__ u64 smem[];
  __shared__ u64 gone[kGroup];  // the next group's tiles' words, as staged
  __shared__ int n_list[2];
  const int nw = words(k), ng = (nw + kGroup - 1) / kGroup;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const u64* m = mask + (size_t)b * k * nw;
  const u64* sum = summary + (size_t)b * k * summary_words(nw);
  const uint8_t* v = valid + (size_t)b * k;
  u64* removed = smem;
  u64* staged = smem + nw;  // two groups of 512 rows x kStride words
  int* lists = reinterpret_cast<int*>(staged + 2 * kGroupRows * kStride);  // 2 x 512

  for (int w = warp; w < nw; w += kScanThreads / 32) {
    const int i = w * kTile + lane;
    const unsigned lo = __ballot_sync(~0u, i >= k || !v[i]);
    const unsigned hi = __ballot_sync(~0u, i + 32 >= k || !v[i + 32]);
    if (lane == 0) removed[w] = (u64)lo | ((u64)hi << 32);
  }
  __syncthreads();
  if (warp > 0) stage_group(m, sum, k, nw, 0, removed, staged);
  __syncthreads();

  for (int g = 0; g < ng; ++g) {
    const u64* cur = staged + (g & 1) * kGroupRows * kStride;
    int* list = lists + (g & 1) * kGroupRows;
    const int w0 = g * kGroup;  // the window's first word
    if (warp == 0) {
      // the window's words of `removed` stay in registers for the group
      u64 win[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) win[u] = w0 + u < nw ? removed[w0 + u] : 0;
      int nk = 0;
#pragma unroll
      for (int tt = 0; tt < kGroup; ++tt) {
        if (w0 + tt >= nw) break;
        const u64* ra = cur + (tt * kTile + lane) * kStride;  // staged rows lane, lane + 32
        const u64* rb = ra + 32 * kStride;
        u64 rem = win[tt];
        // a row removed before it was staged reads as 0
        const u64 d0 = (rem >> lane) & 1 ? 0 : ra[tt];
        const u64 d1 = (rem >> (lane + 32)) & 1 ? 0 : rb[tt];
        const u64 nz = (u64)__ballot_sync(~0u, d0 != 0) |
                       ((u64)__ballot_sync(~0u, d1 != 0) << 32);
        // live rows that suppress a row of this tile, in order; a row's
        // diagonal word holds only later rows, so `rem` below it is final
        u64 todo = ~rem & nz;
        while (todo) {
          const int r = __ffsll((long long)todo) - 1;
          const u64 d = __shfl_sync(~0u, r < 32 ? d0 : d1, r & 31);
          rem |= d;
          todo &= (todo - 1) & ~d;
        }
        win[tt] = rem;
        const u64 kept = ~rem;
        const bool k0 = (kept >> lane) & 1, k1 = (kept >> (lane + 32)) & 1;
        if (k0) list[nk + __popcll(kept & ((1ull << lane) - 1))] = tt * kTile + lane;
        if (k1) list[nk + __popcll(kept & ((1ull << (lane + 32)) - 1))] = tt * kTile + lane + 32;
        nk += __popcll(kept);
        // the kept rows' later words of the window, where any is nonzero
        u64 x[kGroup], any = 0;
#pragma unroll
        for (int u = tt + 1; u < kGroup; ++u) {
          x[u] = (k0 ? ra[u] : 0) | (k1 ? rb[u] : 0);
          any |= x[u];
        }
        if (__any_sync(~0u, any != 0)) {
#pragma unroll
          for (int u = tt + 1; u < kGroup; ++u) win[u] |= or_across_warp(x[u]);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          if (w0 + u < nw) removed[w0 + u] = win[u];
        n_list[g & 1] = nk;
      }
    } else {
      // the next group's live rows, as `removed` stands now (it only grows)
      if (g + 1 < ng) {
        if (tid - 32 < kGroup)
          gone[tid - 32] = w0 + kGroup + tid - 32 < nw ? removed[w0 + kGroup + tid - 32] : 0;
        // the snapshot is taken before any helper ORs into `removed`
        asm volatile("bar.sync 1, %0;\n" ::"n"(kHelpers) : "memory");
        stage_group(m, sum, k, nw, g + 1, gone, staged + ((g + 1) & 1) * kGroupRows * kStride);
      }
      // the previous group's kept rows, their nonzero words past this
      // window, from L2: a thread a (row, word of the summary), sixteen
      // loads out before the first atomic
      if (g > 0) {
        const int* prev = lists + ((g - 1) & 1) * kGroupRows;
        const int np = n_list[(g - 1) & 1];
        const int ws = w0 + kGroup, ns = summary_words(nw), nsw = ns - ws / 64;
        for (int item = tid - 32; item < np * nsw; item += kHelpers) {
          const int i = (g - 1) * kGroupRows + prev[item / nsw];
          const int sw = ws / 64 + item % nsw;
          u64 bits = sum[(size_t)i * ns + sw];
          if (sw == ws / 64) bits &= ~0ull << (ws % 64);
          const u64* mrow = m + (size_t)i * nw;
          while (bits) {
            int wv[kBatch];
            u64 xv[kBatch];
#pragma unroll
            for (int c = 0; c < kBatch; ++c) {
              wv[c] = bits ? sw * 64 + __ffsll((long long)bits) - 1 : -1;
              bits &= bits - 1;
              xv[c] = wv[c] >= 0 ? mrow[wv[c]] : 0;
            }
#pragma unroll
            for (int c = 0; c < kBatch; ++c)
              if (wv[c] >= 0) atomic_or_words(&removed[wv[c]], xv[c]);
          }
        }
      }
    }
    __syncthreads();
    // the group's kept rows, words of the next window (staged): warp u
    // takes word u of the window
    if (warp < kGroup && w0 + kGroup + warp < nw) {
      const int nk = n_list[g & 1];
      u64 acc = 0;
#pragma unroll 4
      for (int q = lane; q < nk; q += 32) acc |= cur[list[q] * kStride + kGroup + warp];
      acc = or_across_warp(acc);
      if (lane == 0) removed[w0 + kGroup + warp] |= acc;
    }
    __syncthreads();
  }
  for (int i = tid; i < k; i += kScanThreads)
    keep[(size_t)b * k + i] = ((removed[i / kTile] >> (i % kTile)) & 1) ? 0 : 1;
}

// Launch the scan on `s` (after the mask pass on the same stream).
inline cudaError_t launch_scan(u64* workspace, const uint8_t* valid, int batch, int k,
                               uint8_t* keep, cudaStream_t s) {
  const size_t bytes = scan_smem_bytes(words(k));
  cudaFuncSetAttribute(nms_sweep_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  nms_sweep_scan_kernel<<<batch, kScanThreads, bytes, s>>>(
      workspace, summary_of(workspace, batch, k), valid, k, keep);
  return cudaGetLastError();
}

}  // namespace nms
