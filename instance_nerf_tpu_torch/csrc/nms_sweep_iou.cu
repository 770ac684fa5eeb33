// Greedy NMS sweep over a precomputed, score-ordered IoU matrix (B2).
//
// Replaces instance_nerf_tpu/kernels/nms_pallas.py:nms_sweep_pallas
// (Pallas body _sweep_kernel). Computes, for each independent problem b,
// the greedy keep mask over K score-ordered boxes: box i is kept iff it is
// valid and no earlier kept box j has iou[j, i] > thr (compared in f32).
// Invalid boxes are never kept and never suppress. The IoU matrix comes
// from the caller (the rotated IoU of ops/rotated_iou.py for OBBs).
//
// Design: the serial dependency is only in the keep decisions; every test
// iou[i, j] > thr is independent of them. So it runs in two phases.
//
// 1. Mask pass (nms_sweep_iou_mask_kernel), over the whole card: a grid
//    of (64-column word w, 64-row tile t, problem), tiles left of the
//    diagonal skipped. One warp forms a row's word from two __ballot_syncs
//    of 32 coalesced f32 reads each and writes it to the (B, K, W) uint64
//    mask of nms_scan.cuh (bit c of word w of row i: j = 64w + c,
//    i < j < K, iou[i, j] > thr), marking a nonzero word in the mask's
//    summary. It reads only the upper triangle, about 32 MB at K = 4000:
//    about 0.01 ms at 3.35 TB/s.
// 2. Scan (nms_scan.cuh): one block per problem walks the K / 64 tiles in
//    groups of 8, one warp resolving each tile's diagonal word in registers
//    while the others stage rows and OR the kept rows' later words into a
//    shared-memory bitset.
//
// What bounds it: the mask pass's read of the upper triangle, and the
// scan's chain of about K / 64 tile steps in one warp (for dense masks, the
// L2 reads of the kept rows' words by one SM). Nothing is rounded, so the
// keep mask equals the plain PyTorch sweep's bit for bit.

#include "nms_scan.cuh"

namespace {

using nms::u64;

constexpr int kMaskThreads = 256;  // 8 warps, 8 rows each

__global__ void __launch_bounds__(kMaskThreads)
nms_sweep_iou_mask_kernel(const float* __restrict__ iou,  // (B, K, K)
                          float thr, int k,
                          u64* __restrict__ mask,         // (B, K, W)
                          u64* __restrict__ sum) {        // (B, K, ceil(W / 64))
  const int w = blockIdx.x, t = blockIdx.y, b = blockIdx.z;
  if (w < t) return;  // left of the diagonal: never read
  const int nw = nms::words(k);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = w * nms::kTile + lane, j1 = j0 + 32;
  const float* g = iou + (size_t)b * k * k;
  constexpr int kRows = nms::kTile / 8;  // rows of this warp
  bool h0[kRows], h1[kRows];
  // all 16 reads of a lane are issued before the first compare is used
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = t * nms::kTile + warp + 8 * q;
    const float* row = g + (size_t)i * k;
    h0[q] = i < k && j0 > i && j0 < k && row[j0] > thr;
    h1[q] = i < k && j1 > i && j1 < k && row[j1] > thr;
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = t * nms::kTile + warp + 8 * q;
    const unsigned lo = __ballot_sync(~0u, h0[q]);
    const unsigned hi = __ballot_sync(~0u, h1[q]);
    if (lane == 0 && i < k)
      nms::store_word(mask, sum, nw, (size_t)b * k + i, w, (u64)lo | ((u64)hi << 32));
  }
}

}  // namespace

extern "C" {

// Launch both phases on `stream`: `iou` is (B, K, K) f32, `valid` and
// `keep` (B, K) bool, `workspace` the uint64 mask and summary (nms_scan.cuh)
// the caller allocated. Returns the first CUDA error of the launches (0 on
// success); the wrapper raises on anything else.
int nms_sweep_iou_launch(const float* iou, const uint8_t* valid, float thr, int batch, int k,
                         u64* workspace, uint8_t* keep, void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  if (k > nms::kMaxK || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nw = nms::words(k);
  u64* sum = nms::summary_of(workspace, batch, k);
  cudaError_t err = cudaMemsetAsync(sum, 0, nms::summary_bytes(batch, k), s);
  if (err != cudaSuccess) return (int)err;
  nms_sweep_iou_mask_kernel<<<dim3(nw, nw, batch), kMaskThreads, 0, s>>>(iou, thr, k,
                                                                         workspace, sum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)nms::launch_scan(workspace, valid, batch, k, keep, s);
}

}  // extern "C"
