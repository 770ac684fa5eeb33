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
// (N / (L * trailing), L, trailing): point, level, corner; trailing = 8 for
// the hash encoding's corners and 1 for the brick encoding), in one launch
// where the TPU makes one call per level. An out-of-range index lands in row
// 0 or T - 1 of its own level, never outside it. The launch zeroes `out`
// first (a memset on the same stream); the caller, for replicas > 1, sums
// the copies.
//
// What bounds it on Hopper: the atomics. The bytes (updates and indices
// read once, the table written once) take about 0.1 ms at 3.35 TB/s at the
// largest shape of the training step (16.8M updates of 2 floats into 2^23
// rows), but every update is a read-modify-write in L2, which takes about
// 1e11 vector REDs a second whatever their width (float2 or float4), and
// updates of one row serialise there. So the design issues as few REDs as
// it can: one per row, not per float, and none for an update that the
// previous one of its thread already hit (the samples of a ray fall into
// the same cells of the coarse levels).
//
// Design:
// - One thread per update, or up to kMaxLanes threads for a row of that
//   many 16-byte vectors (W = 32 of the brick field: 8 lanes, one float4
//   RED each): the whole row in vector REDs (W = 2 one float2 RED, W % 4 ==
//   0 float4 REDs, any other W scalar ones). No division in the loops: a
//   thread's lane, corner and range of points are fixed at its start, and
//   u = point * L * trailing + level * trailing + corner.
// - Each thread walks a contiguous range of points with kRun points' loads
//   in flight, and sums consecutive updates of the same row in registers:
//   the samples of one ray that share a coarse cell cost one RED (on the
//   main field, samples lie about 1/128 apart along a ray and the cells of
//   levels 0-5 are 1/15 to 1/63 wide). This is what keeps the dense levels
//   cheap; shared-memory copies of them would not pay here, since
//   shared-memory f32 atomics are compare-and-swap loops on sm_90.
// - Level-major: a block takes a range of points of one level and blocks
//   are numbered level after level, so the blocks in flight work on a
//   level or two and its table rows stay in L2.
// Summation order is free, so the result equals the plain index_add_
// version to float rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRun = 8;         // points whose loads a thread keeps in flight
constexpr int kMaxLanes = 8;    // threads that share one update's row
constexpr int kThreads = 256;   // threads per block (scatter_cuda.THREADS)

struct Plan {
  uint32_t lanes;             // threads per update, each a share of the row
  uint32_t blocks_per_level;  // blocks of each level
  uint32_t points_per_block;  // points a block covers
};

template <int VEC> struct VecOf;
template <> struct VecOf<1> { using T = float; };
template <> struct VecOf<2> { using T = float2; };
template <> struct VecOf<4> { using T = float4; };

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// One level's rows of the table: lvl_out is the level's first row, copy the
// floats of one replica of the whole table.
struct Dest {
  float* lvl_out;
  uint32_t w, replicas;
  size_t copy;
};

template <int VEC>
__device__ __forceinline__ void add_row(const Dest& d, uint32_t u, int32_t r, uint32_t c,
                                        typename VecOf<VEC>::T v) {
  using V = typename VecOf<VEC>::T;
  float* dst = d.lvl_out + (size_t)r * d.w + c * VEC;
  if (d.replicas > 1) dst += (size_t)(u % d.replicas) * d.copy;
  atomicAdd(reinterpret_cast<V*>(dst), v);
}

// Adds this thread's share (chunks c0, c0 + lanes, ... of each row) of the
// updates of its corner at points [p_first, p_end) of level
// `lvl_off / trailing`, kRun points' loads in flight at a time. Consecutive
// points that land on the same row (the samples of one ray in one coarse
// cell) are summed in registers, so a run of them costs one atomic.
template <int VEC>
__device__ __forceinline__ void scatter_range(
    const int32_t* __restrict__ idx, const float* __restrict__ upd, uint32_t n,
    uint32_t group, uint32_t lvl_off, int64_t base, int32_t rows_per_level, uint32_t p_first,
    uint32_t p_end, uint32_t c0, uint32_t lanes, const Dest& d) {
  using V = typename VecOf<VEC>::T;
  const uint32_t w = d.w, chunks = w / VEC;
  for (uint32_t c = c0; c < chunks; c += lanes) {
    V acc = {};
    int32_t row = -1;
    uint32_t u_row = 0;
    for (uint32_t p = p_first; p < p_end; p += kRun) {
      const uint32_t u0 = p * group + lvl_off;
      int32_t r[kRun];
      V v[kRun];
      uint32_t valid = 0;
      // all loads first (the update row's does not wait for the index's),
      // streaming: each is read once, and L2 is kept for the table
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        const uint32_t u = u0 + k * group;
        const bool in = p + k < p_end && u < n;
        valid |= (uint32_t)in << k;
        r[k] = in ? __ldcs(idx + u) : 0;
        v[k] = in ? __ldcs(reinterpret_cast<const V*>(upd + (size_t)u * w + c * VEC)) : V{};
      }
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        if (!((valid >> k) & 1u)) break;
        const int64_t rr = (int64_t)r[k] - base;
        const int32_t rk =
            rr < 0 ? 0 : (rr >= rows_per_level ? rows_per_level - 1 : (int32_t)rr);
        if (rk == row) {
          acc = add(acc, v[k]);
        } else {
          if (row >= 0) add_row<VEC>(d, u_row, row, c, acc);
          row = rk;
          acc = v[k];
          u_row = u0 + k * group;
        }
      }
    }
    if (row >= 0) add_row<VEC>(d, u_row, row, c, acc);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const int32_t* __restrict__ idx,  // (N,)
                   const float* __restrict__ upd,    // (N, W)
                   uint32_t n, uint32_t w, uint32_t n_levels, uint32_t trailing,
                   int32_t rows_per_level, uint32_t replicas, const Plan plan,
                   float* __restrict__ out) {        // (replicas, L * T, W)
  const uint32_t group = n_levels * trailing;  // updates per point
  const uint32_t points = (n + group - 1) / group;
  // this thread's chunk of a row, corner and range of points, fixed for
  // the whole block (the only divisions)
  const uint32_t lanes = plan.lanes;
  const uint32_t c0 = threadIdx.x % lanes;
  const uint32_t rest = threadIdx.x / lanes;
  const uint32_t corner = rest % trailing;
  const uint32_t slot = rest / trailing;
  const uint32_t slots = kThreads / (lanes * trailing);  // point ranges per block
  if (slot >= slots) return;
  const uint32_t lvl = blockIdx.x / plan.blocks_per_level;
  const uint32_t p_lo = (blockIdx.x - lvl * plan.blocks_per_level) * plan.points_per_block;
  const uint32_t p_hi = min(points, p_lo + plan.points_per_block);
  const int64_t base = (int64_t)lvl * rows_per_level;
  const Dest d = {out + (size_t)base * w, w, replicas, (size_t)n_levels * rows_per_level * w};
  const uint32_t len = plan.points_per_block / slots;  // passes * kRun
  const uint32_t first = min(p_hi, p_lo + slot * len);
  scatter_range<VEC>(idx, upd, n, group, lvl * trailing + corner, base, rows_per_level,
                     first, min(p_hi, first + len), c0, lanes, d);
}

template <int VEC>
int launch(const int32_t* idx, const float* upd, uint32_t n, uint32_t w, uint32_t n_levels,
           uint32_t trailing, int32_t rows_per_level, uint32_t replicas, uint32_t blocks,
           const Plan& plan, float* out, cudaStream_t s) {
  scatter_add_kernel<VEC><<<blocks, kThreads, 0, s>>>(idx, upd, n, w, n_levels, trailing,
                                                      rows_per_level, replicas, plan, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch's arguments, in one struct so that the host call converts one
// pointer (kernels/scatter_cuda.py:_LaunchArgs mirrors it). Each thread
// takes `passes` runs of kRun points (scatter_cuda.scatter_plan).
struct LaunchArgs {
  const int32_t* idx;  // (N,)
  const float* upd;    // (N, W)
  float* out;          // (replicas, L * T, W), zeroed by the launch
  void* stream;
  long long n;
  int w, n_levels, trailing, rows_per_level, replicas, passes;
};

// Zero `out`, then launch, both on `stream`. Returns the first CUDA error
// (0 on success); the wrapper raises on anything else. n * w must stay
// below 2^31.
int scatter_add_launch(const LaunchArgs* args) {
  const LaunchArgs A = *args;
  const long long n = A.n;
  const int w = A.w, n_levels = A.n_levels, trailing = A.trailing;
  if (n < 0 || w <= 0 || n_levels <= 0 || trailing <= 0 || trailing > kThreads ||
      A.rows_per_level <= 0 || A.replicas <= 0 || A.passes <= 0)
    return (int)cudaErrorInvalidValue;
  if ((unsigned long long)n * (unsigned long long)w >= (1ull << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(A.stream);
  // the table zeroed here, not by a separate PyTorch call: one dispatch less
  // for the host, the same bytes for the card
  const size_t table_bytes =
      (size_t)A.replicas * n_levels * A.rows_per_level * w * sizeof(float);
  cudaError_t e = cudaMemsetAsync(A.out, 0, table_bytes, s);
  if (e != cudaSuccess || n == 0) return (int)e;

  // the widest vector access that W and the update rows' alignment allow,
  // and up to kMaxLanes threads per update where the row has that many
  // vectors (a power of two of them)
  const uintptr_t a = (uintptr_t)A.upd | (uintptr_t)A.out;
  const int vec = (w % 4 == 0 && a % 16 == 0) ? 4 : (w % 2 == 0 && a % 8 == 0) ? 2 : 1;
  const int chunks = w / vec;
  int lanes = 1;
  while (lanes < kMaxLanes && chunks % (2 * lanes) == 0 && 2 * lanes * trailing <= kThreads)
    lanes *= 2;
  Plan plan;
  plan.lanes = lanes;
  const unsigned long long group = (unsigned long long)n_levels * trailing;
  const unsigned long long points = ((unsigned long long)n + group - 1) / group;
  const unsigned long long per_block =
      (unsigned long long)A.passes * kRun * (kThreads / (lanes * trailing));
  if (per_block >= (1ull << 31)) return (int)cudaErrorInvalidValue;
  plan.points_per_block = (uint32_t)per_block;
  plan.blocks_per_level = (uint32_t)((points + per_block - 1) / per_block);
  const unsigned long long blocks = (unsigned long long)n_levels * plan.blocks_per_level;
  if (blocks >= (1ull << 31)) return (int)cudaErrorInvalidValue;
  const uint32_t nn = (uint32_t)n;
  if (vec == 4)
    return launch<4>(A.idx, A.upd, nn, w, n_levels, trailing, A.rows_per_level, A.replicas,
                     (uint32_t)blocks, plan, A.out, s);
  if (vec == 2)
    return launch<2>(A.idx, A.upd, nn, w, n_levels, trailing, A.rows_per_level, A.replicas,
                     (uint32_t)blocks, plan, A.out, s);
  return launch<1>(A.idx, A.upd, nn, w, n_levels, trailing, A.rows_per_level, A.replicas,
                   (uint32_t)blocks, plan, A.out, s);
}

}  // extern "C"
