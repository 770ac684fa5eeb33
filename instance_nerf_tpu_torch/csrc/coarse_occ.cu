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
// What bounds it on Hopper: bytes, 16 a point (12 of cell ids read, 4 of
// occupancy written); the grid (32 KB at R = 32) is read by every point but
// stays in L1 and L2. At the 524,288 points of a training batch that is
// 8.4 MB, about 2.5 us at 3.35 TB/s, so the kernel is short and the launch
// around it (kernels/coarse_occ_cuda.py) has to be lean too.
//
// Design: four points per thread, which is 48 bytes of cell ids: three
// 16-byte loads, and one 16-byte store of the four results. A cells tensor
// sliced off a 16-byte boundary (cells[1:]) starts with up to three points
// on their own, and the last N % 4 points after the groups are handled one
// a thread too, so any N and any base offset work; where the output of the
// first group is off its 16-byte boundary the four results are stored one
// by one. The grid byte is read through the read-only cache: staging it in
// shared memory per block would read more L2 bytes than the point data.
// Values are copied, so the result equals the plain indexing version
// exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float occ(const uint8_t* __restrict__ grid, int r, int x, int y,
                                     int z) {
  const bool inside = (unsigned)x < (unsigned)r && (unsigned)y < (unsigned)r &&
                      (unsigned)z < (unsigned)r;
  return inside ? (float)__ldg(grid + ((size_t)x * r + y) * r + z) : 0.0f;
}

__device__ __forceinline__ float occ_at(const int32_t* __restrict__ cells,
                                        const uint8_t* __restrict__ grid, int r, int i) {
  const int32_t* c = cells + 3 * (size_t)i;
  return occ(grid, r, __ldg(c), __ldg(c + 1), __ldg(c + 2));
}

// Points [0, head) and [tail, n) one per thread; the groups of four in
// between one group per thread, cells[head] on a 16-byte boundary.
template <bool kVecStore>
__global__ void __launch_bounds__(kThreads)
coarse_occ_kernel(const int32_t* __restrict__ cells,  // (N, 3)
                  const uint8_t* __restrict__ grid,   // (R, R, R)
                  int r, int n, int head, int groups,
                  float* __restrict__ out) {          // (N,)
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int tail = head + 4 * groups;
  if (g < head) out[g] = occ_at(cells, grid, r, g);
  if (g < n - tail) out[tail + g] = occ_at(cells, grid, r, tail + g);
  if (g >= groups) return;
  const int p = head + 4 * g;
  const int4* c4 = reinterpret_cast<const int4*>(cells + 3 * (size_t)p);
  const int4 a = __ldg(c4), b = __ldg(c4 + 1), c = __ldg(c4 + 2);
  const float4 o = make_float4(occ(grid, r, a.x, a.y, a.z), occ(grid, r, a.w, b.x, b.y),
                               occ(grid, r, b.z, b.w, c.x), occ(grid, r, c.y, c.z, c.w));
  if (kVecStore) {
    *reinterpret_cast<float4*>(out + p) = o;
  } else {
    out[p] = o.x;
    out[p + 1] = o.y;
    out[p + 2] = o.z;
    out[p + 3] = o.w;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`. Returns cudaGetLastError() after the launch (0 on
// success); the wrapper raises on anything else.
int coarse_occ_launch(const int32_t* cells, const uint8_t* grid, int r, int n,
                      float* out, void* stream) {
  if (n <= 0) return 0;
  if (r <= 0 || (uintptr_t)cells % 4) return (int)cudaErrorInvalidValue;
  // the first point whose cell ids start on a 16-byte boundary
  int head = 0;
  while ((((uintptr_t)(cells + 3 * head)) % 16) != 0) ++head;  // at most 3
  if (head > n) head = n;
  const int groups = (n - head) / 4;
  const int threads = groups > 3 ? groups : 3;
  const int blocks = (threads + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((uintptr_t)(out + head) % 16 == 0)
    coarse_occ_kernel<true><<<blocks, kThreads, 0, s>>>(cells, grid, r, n, head, groups, out);
  else
    coarse_occ_kernel<false><<<blocks, kThreads, 0, s>>>(cells, grid, r, n, head, groups, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
