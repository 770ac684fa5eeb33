// Greedy 3D AABB NMS sweep with the IoU computed in the kernel (B1).
//
// Replaces instance_nerf_tpu/kernels/nms_pallas.py:nms_boxes_pallas
// (Pallas body _sweep_fused_kernel). Computes, for each independent problem
// b, the greedy keep mask over K score-ordered boxes: box i is kept iff it
// is valid and no earlier kept box j has IoU(j, i) > thr. Invalid boxes are
// never kept and never suppress. The (K, K) IoU matrix never exists.
//
// Design: the serial dependency is only in the keep decisions; every test
// IoU(i, j) > thr is independent of them. So it runs in two phases.
//
// 1. Mask pass (nms_sweep_mask_kernel), over the whole card: a grid of
//    (64-column word w, 64-row tile t, problem), tiles left of the diagonal
//    skipped. A block stages its column tile's 64 boxes (lo, hi, volume) in
//    shared memory; each of its 64 threads computes one row's 64 IoUs and
//    writes them as one word of the (B, K, W) uint64 mask of nms_scan.cuh
//    (bit c of word w of row i: j = 64w + c, i < j < K, IoU(i, j) > thr),
//    marking a nonzero word in the mask's summary. It reads the caller's
//    (B, K, 6) boxes and bool valid bytes as they are.
// 2. Scan (nms_scan.cuh): one block per problem walks the K / 64 tiles in
//    groups of 8, one warp resolving each tile's diagonal word in registers
//    while the others stage rows and OR the kept rows' later words into a
//    shared-memory bitset.
//
// What bounds it: the scan's chain of about K / 64 tile steps in one warp,
// and for dense masks the L2 reads of the kept rows' words by one SM; the
// mask pass's K^2 / 2 IoU tests (about 18 operations each, the division
// only where the boxes intersect) run over the whole card and take a
// fraction of that at the path's sizes.
//
// The IoU uses the exact formula of ops/boxes.py:box_iou_3d, each volume
// computed here as (dx * dy) * dz as ops/boxes.py:aabb_volume rounds it,
// with IEEE-rounded intrinsics (no FMA contraction, no fast division), so
// keep decisions are bit-identical to the plain PyTorch sweep. Where the
// intersection is 0 the quotient is 0, so the division is skipped there.

#include "nms_scan.cuh"

namespace {

using nms::u64;

__device__ __forceinline__ float volume(float x1, float y1, float z1, float x2, float y2,
                                        float z2) {
  return __fmul_rn(__fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1)), __fsub_rn(z2, z1));
}

__global__ void __launch_bounds__(nms::kTile)
nms_sweep_mask_kernel(const float* __restrict__ boxes,  // (B, K, 6)
                      float thr, int k,
                      u64* __restrict__ mask,           // (B, K, W)
                      u64* __restrict__ sum) {          // (B, K, ceil(W / 64))
  const int w = blockIdx.x, t = blockIdx.y, b = blockIdx.z;
  if (w < t) return;  // left of the diagonal: never read
  const int nw = nms::words(k);
  __shared__ float4 lo_s[nms::kTile];  // x1 y1 z1 volume
  __shared__ float4 hi_s[nms::kTile];  // x2 y2 z2 -
  const float* g = boxes + (size_t)b * k * 6;
  const int c = threadIdx.x;
  const int j = w * nms::kTile + c;
  if (j < k) {
    const float* p = g + (size_t)j * 6;
    lo_s[c] = make_float4(p[0], p[1], p[2], volume(p[0], p[1], p[2], p[3], p[4], p[5]));
    hi_s[c] = make_float4(p[3], p[4], p[5], 0.f);
  } else {
    lo_s[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    hi_s[c] = lo_s[c];
  }
  const int i = t * nms::kTile + c;
  float ax1 = 0.f, ay1 = 0.f, az1 = 0.f, ax2 = 0.f, ay2 = 0.f, az2 = 0.f;
  if (i < k) {
    const float* p = g + (size_t)i * 6;
    ax1 = p[0], ay1 = p[1], az1 = p[2], ax2 = p[3], ay2 = p[4], az2 = p[5];
  }
  const float avol = volume(ax1, ay1, az1, ax2, ay2, az2);
  __syncthreads();
  if (i >= k) return;

  u64 word = 0;
#pragma unroll 4
  for (int q = 0; q < nms::kTile; ++q) {
    const float4 l = lo_s[q], h = hi_s[q];
    const float wx = fmaxf(__fsub_rn(fminf(ax2, h.x), fmaxf(ax1, l.x)), 0.f);
    const float wy = fmaxf(__fsub_rn(fminf(ay2, h.y), fmaxf(ay1, l.y)), 0.f);
    const float wz = fmaxf(__fsub_rn(fminf(az2, h.z), fmaxf(az1, l.z)), 0.f);
    const float inter = __fmul_rn(__fmul_rn(wx, wy), wz);
    const float uni = __fsub_rn(__fadd_rn(avol, l.w), inter);
    float iou = 0.f;
    if (inter > 0.f && uni > 0.f) iou = __fdiv_rn(inter, fmaxf(uni, 1e-12f));
    word |= (u64)(iou > thr) << q;
  }
  const int first = i - w * nms::kTile + 1;  // lowest bit with j > i
  if (first > 0) word = first >= nms::kTile ? 0 : word & (~0ull << first);
  const int end = k - w * nms::kTile;        // bits with j < k
  if (end < nms::kTile) word &= (1ull << end) - 1;
  nms::store_word(mask, sum, nw, (size_t)b * k + i, w, word);
}

}  // namespace

extern "C" {

// Launch both phases on `stream`: `boxes` is (B, K, 6) f32, `valid` and
// `keep` (B, K) bool, `workspace` the uint64 mask and summary (nms_scan.cuh)
// the caller allocated. Returns the first CUDA error of the launches (0 on
// success); the wrapper raises on anything else.
int nms_sweep_launch(const float* boxes, const uint8_t* valid, float thr, int batch, int k,
                     u64* workspace, uint8_t* keep, void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  if (k > nms::kMaxK || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nw = nms::words(k);
  u64* sum = nms::summary_of(workspace, batch, k);
  cudaError_t err = cudaMemsetAsync(sum, 0, nms::summary_bytes(batch, k), s);
  if (err != cudaSuccess) return (int)err;
  nms_sweep_mask_kernel<<<dim3(nw, nw, batch), nms::kTile, 0, s>>>(boxes, thr, k, workspace,
                                                                    sum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)nms::launch_scan(workspace, valid, batch, k, keep, s);
}

}  // extern "C"
