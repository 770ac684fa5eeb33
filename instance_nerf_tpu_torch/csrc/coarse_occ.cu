// Coarse-occupancy lookup: the occupancy bit of each sample's coarse cell.
//
// Replaces instance_nerf_tpu/kernels/coarse_occ_pallas.py:coarse_occ_lookup
// (Pallas body _kernel). Computes out[i] = grid[x_i, y_i, z_i] for (N, 3)
// int32 cell ids and an (R, R, R) occupancy grid of {0, 1} bytes. The TPU
// kernel takes cells inside the grid; here a cell outside it gives 0.
//
// The TPU kernel avoids a gather (Mosaic has no dynamic gather) by a one-hot
// bf16 matmul over x and a one-hot reduce over (y, z) per block of 4096
// points, and needs N to be a multiple of that block. Hopper gathers
// directly, so none of that carries over.
//
// What bounds it on Hopper: bytes. Each point reads 12 bytes of cell ids and
// writes 4 bytes; the grid (32 KB at R = 32) is read by every point but
// stays in L1 and L2, so the device-memory traffic is 16 bytes a point.
//
// Design: one thread per point, no block-multiple contract; the grid byte is
// read through the read-only cache. Values are copied, so the result equals
// the plain indexing version exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
coarse_occ_kernel(const int32_t* __restrict__ cells,  // (N, 3)
                  const uint8_t* __restrict__ grid,   // (R, R, R)
                  int r, int n,
                  float* __restrict__ out) {          // (N,)
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = __ldg(cells + 3 * (size_t)i);
  const int y = __ldg(cells + 3 * (size_t)i + 1);
  const int z = __ldg(cells + 3 * (size_t)i + 2);
  const bool inside = (unsigned)x < (unsigned)r && (unsigned)y < (unsigned)r &&
                      (unsigned)z < (unsigned)r;
  out[i] = inside ? (float)__ldg(grid + ((size_t)x * r + y) * r + z) : 0.0f;
}

}  // namespace

extern "C" {

// Launch on `stream`. Returns cudaGetLastError() after the launch (0 on
// success); the wrapper raises on anything else.
int coarse_occ_launch(const int32_t* cells, const uint8_t* grid, int r, int n,
                      float* out, void* stream) {
  if (n <= 0) return 0;
  if (r <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kThreads - 1) / kThreads;
  coarse_occ_kernel<<<blocks, kThreads, 0, s>>>(cells, grid, r, n, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
