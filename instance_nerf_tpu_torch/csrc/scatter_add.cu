// Row scatter-add into a zeroed table: the hash/brick-table gradient.
//
// Replaces instance_nerf_tpu/kernels/scatter_pallas.py:scatter_add_pallas
// (Pallas bodies _scatter_kernel and _make_replica_kernel, wrapper
// scatter_add_padded) and the backward of gather_rows_pallas_grad. Computes
//
//   out[rep(u)][lvl(u) * T + clamp(idx[u] - lvl(u) * T, 0, T - 1), :] += upd[u, :]
//
// for every update u, with lvl(u) = (u / trailing) % n_levels and
// rep(u) = u % replicas. With n_levels = 1 this is
// zeros((T, W)).at[clip(idx, 0, T - 1)].add(upd); with n_levels = L it is
// the whole multi-level table gradient of one gather (the index layout
// (N, L, trailing), trailing = 8 for the hash encoding's corners and 1 for
// the brick encoding), in one launch where the TPU makes one call per level.
// An out-of-range index lands in row 0 or T - 1 of its own level, never
// outside it. The caller zeroes `out` and, for replicas > 1, sums the copies.
//
// What bounds it on Hopper: not bytes. The updates, indices and table move
// once at 3.35 TB/s in about 0.1 ms at the largest shape of the training
// step (16.8M updates of 2 floats into 2^23 rows); the f32 atomics that
// resolve the collisions take longer. Updates that hit the same row
// serialise in L2, and the dense levels of a hash grid (4096 rows for a
// million updates at level 0) collide hundreds of times per row.
//
// Design (simple first): one thread per (update, column), grid-stride, a
// fire-and-forget f32 atomicAdd (RED) into the table in device memory.
// Neighbouring threads read neighbouring update floats, so the reads are
// coalesced. The TPU kernel's serial walk over a VMEM-resident slab, and the
// replicas that break its read-modify-write chain, have no counterpart:
// replicas here only spread the atomics of one row over disjoint copies.
// Summation order is free, so the result equals the plain
// index_add_ version to float rounding, not bit for bit. Privatising the
// dense levels in shared memory is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;  // 32 resident blocks' worth per SM

__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const int32_t* __restrict__ idx,  // (N,)
                   const float* __restrict__ upd,    // (N, W)
                   uint32_t total,                   // N * W
                   uint32_t w, uint32_t n_levels, uint32_t trailing,
                   int32_t rows_per_level, uint32_t replicas,
                   float* __restrict__ out) {        // (replicas, L * T, W)
  const size_t copy = (size_t)n_levels * rows_per_level * w;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
    const uint32_t u = e / w;
    const uint32_t col = e - u * w;
    const int32_t lvl = (int32_t)((u / trailing) % n_levels);
    const int64_t base = (int64_t)lvl * rows_per_level;
    int64_t r = (int64_t)__ldg(idx + u) - base;
    r = r < 0 ? 0 : (r >= rows_per_level ? rows_per_level - 1 : r);
    float* dst = out + (size_t)(u % replicas) * copy + (size_t)(base + r) * w + col;
    atomicAdd(dst, __ldg(upd + e));
  }
}

}  // namespace

extern "C" {

// Launch on `stream`. Returns cudaGetLastError() after the launch (0 on
// success); the wrapper raises on anything else. n * w must stay below 2^31
// so that the grid-stride index never wraps.
int scatter_add_launch(const int32_t* idx, const float* upd, long long n, int w,
                       int n_levels, int trailing, int rows_per_level, int replicas,
                       float* out, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  if (n_levels <= 0 || trailing <= 0 || rows_per_level <= 0 || replicas <= 0)
    return (int)cudaErrorInvalidValue;
  const unsigned long long total = (unsigned long long)n * (unsigned long long)w;
  if (total >= (1ull << 31)) return (int)cudaErrorInvalidValue;
  unsigned long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  scatter_add_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      idx, upd, (uint32_t)total, (uint32_t)w, (uint32_t)n_levels, (uint32_t)trailing,
      rows_per_level, (uint32_t)replicas, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
