// Greedy NMS sweep over a precomputed, score-ordered IoU matrix.
//
// Replaces instance_nerf_tpu/kernels/nms_pallas.py:nms_sweep_pallas
// (Pallas body _sweep_kernel). Computes, for each independent problem b,
// the greedy keep mask over K score-ordered boxes: box i is kept iff it is
// valid and no earlier kept box j has iou[j, i] > thr (compared in f32).
// Invalid boxes are never kept and never suppress. The IoU matrix comes
// from the caller (the rotated IoU of ops/rotated_iou.py for OBBs).
//
// What bounds it: the K-step dependency chain. Row i may only run once
// every earlier row has settled whether i is suppressed, so a problem costs
// K uniform flag reads plus, for each surviving row, one read of that row's
// later columns from device memory (or L2) and one block barrier. The bytes
// the sweep must move (the surviving rows' later columns, 4 B each, and
// 2 B per box for the valid and keep flags) take microseconds at 3.35 TB/s;
// the chain of dependent row reads takes milliseconds.
//
// Design (simple first): one thread block per problem (grid = batch). The
// suppression flags (one byte per box, 4 KB at K = 4096) live in shared
// memory. Rows are walked in order inside the block; every thread reads the
// same flag for row i, so the branch and the barrier after a surviving row
// are uniform. For a surviving row the threads stride over j > i, reading
// iou[i * K + j] coalesced. Nothing is rounded, so the keep mask equals the
// plain PyTorch sweep's bit for bit. A faster design (a bitmask pass over
// all pairs in parallel, then a short serial scan) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
// Shared memory a block may use on sm_90 (227 KB): one flag byte per box.
constexpr int kSmemBytes = 232448;

__global__ void __launch_bounds__(kThreads)
nms_sweep_iou_kernel(const float* __restrict__ iou,      // (B, K, K)
                     const uint8_t* __restrict__ valid,  // (B, K)
                     float thr, int k,
                     uint8_t* __restrict__ keep) {       // (B, K)
  extern __shared__ uint8_t sup[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* g = iou + (size_t)b * k * k;
  const uint8_t* gvalid = valid + (size_t)b * k;
  uint8_t* gkeep = keep + (size_t)b * k;

  for (int t = tid; t < k; t += kThreads) sup[t] = gvalid[t] ? 0 : 1;
  __syncthreads();

  for (int i = 0; i < k; ++i) {
    // sup[i] was last written before a barrier every thread has passed,
    // so `alive` is the same in every thread of the block.
    const bool alive = sup[i] == 0;
    if (tid == 0) gkeep[i] = alive ? 1 : 0;
    if (!alive) continue;
    const float* row = g + (size_t)i * k;
#pragma unroll 4
    for (int j = i + 1 + tid; j < k; j += kThreads) {
      if (row[j] > thr) sup[j] = 1;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launch the sweep on `stream`. Returns cudaGetLastError() after the launch
// (0 on success); the wrapper raises on anything else.
int nms_sweep_iou_launch(const float* iou, const uint8_t* valid, float thr,
                         int batch, int k, uint8_t* keep, void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  if (k > kSmemBytes) return (int)cudaErrorInvalidValue;  // flags do not fit
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaFuncSetAttribute(nms_sweep_iou_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, k);
  nms_sweep_iou_kernel<<<batch, kThreads, (size_t)k, s>>>(iou, valid, thr, k, keep);
  return (int)cudaGetLastError();
}

}  // extern "C"
