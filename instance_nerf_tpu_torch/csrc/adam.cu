// Adam over every leaf of a field in one launch: kernel B7.
//
// Replaces no TPU kernel: on the TPU, optax's update is one XLA fusion per
// leaf. The plain PyTorch version (kernels/adam_cuda.py:adam_update_plain)
// makes 14 tensor operations a leaf, each a pass over the leaf's entries:
// 32 four-byte accesses an entry where the update needs 28 bytes (p, g, mu
// and nu read once; p, mu and nu written once). That is what bounds the
// update on Hopper: bytes. A fleet of 32 hash fields holds 537M table
// entries, 15 GB of least traffic a step, about 4.5 ms at 3.35 TB/s; the
// MLP leaves are a few thousand entries each and only add launches.
//
// Design:
// - One launch for every leaf. The host's table (kernels/adam_cuda.py
//   mirrors Table) gives each leaf's pointers, entry count and mode, and the
//   first of its fixed-size chunks in the chunks of all leaves laid end to
//   end. A persistent grid of a few blocks an SM walks the chunks; a block
//   finds its chunk's leaf by a binary search of the chunk prefix.
// - The table is a kernel parameter (__grid_constant__, read in place from
//   the parameter bank): no upload and no allocation a launch.
// - 16-byte vectors where a leaf's pointers are 16-byte aligned (chunks are
//   a multiple of 4 entries, so every vector of a leaf stays aligned), two
//   of them a thread in flight, and a scalar tail for a leaf's last n % 4
//   entries (the 33-wide instance head) or a leaf off its alignment. A
//   fleet's stacked MLP weights get their gradients from autograd as views
//   transposed in the last two dims; the kernel reads them in that layout,
//   one entry a thread, rather than have the host copy them first.
//   Streaming cache hints: every byte passes once, and 15 GB do not fit in
//   the 50 MB L2.
// - Modes: gradient (the full update); no gradient (the moments decay and
//   the stale momentum still moves p); frozen (the moments decay and p is
//   left alone: the instance stage's non-inst_* leaves).
// - Arithmetic: the plain version's operations in its order, each rounded
//   as PyTorch's CUDA kernels round it, with explicit round-to-nearest
//   intrinsics so that nvcc contracts nothing into an FMA. A division by a
//   host scalar (mu / bc1, nu / bc2) is PyTorch's multiplication by the
//   scalar's f32 reciprocal (div_true_kernel_cuda), computed on the host; a
//   scalar operand of mul or add is the Python float cast to f32. So p, mu
//   and nu equal the plain version's run on the card bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // threads a block (adam_cuda.THREADS)
constexpr int kBlocksPerSm = 4;     // the persistent grid (adam_cuda.BLOCKS_PER_SM)
constexpr long long kChunk = 1 << 14;  // entries a chunk (adam_cuda.CHUNK)
constexpr int kMaxLeaves = 64;      // leaves a launch (adam_cuda.MAX_LEAVES)
constexpr int kUnroll = 2;          // 16-byte vectors of each array a thread holds

}  // namespace

extern "C" {

// The launch table, one kernel parameter (kernels/adam_cuda.py:_Hyper, _Leaf
// and _Table mirror these).
struct Hyper {
  float b1, b2;      // moment decays
  float c1, c2;      // 1 - b1, 1 - b2 in f32
  float ibc1, ibc2;  // f32 reciprocals of the bias corrections
  float eps, neg_lr;
};

struct Leaf {
  float* p;
  const float* g;  // null unless the mode is kGradient
  float* mu;
  float* nu;
  long long n;     // entries
  int chunk0;      // the leaf's first chunk among all leaves' chunks
  int mode;
  // g_cols > 0: g holds p's last two dims (g_rows, g_cols) transposed, as
  // autograd hands over a fleet's stacked weights' gradients
  int g_rows, g_cols;
};

struct Table {
  Leaf leaves[kMaxLeaves];
  int n_leaves;
  int n_chunks;
  Hyper h;
};

}  // extern "C"

namespace {

enum Mode : int { kGradient = 0, kNoGradient = 1, kFrozen = 2 };

// One entry's update, rounded as the plain version's operations are.
template <int MODE>
__device__ __forceinline__ void adam_entry(float& p, float g, float& m, float& v,
                                           const Hyper& h) {
  if (MODE == kGradient) {
    m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g, h.c1));
    v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g, g), h.c2));
  } else {
    m = __fmul_rn(m, h.b1);
    v = __fmul_rn(v, h.b2);
  }
  if (MODE != kFrozen) {
    const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.ibc2)), h.eps);
    p = __fadd_rn(p, __fmul_rn(__fdiv_rn(__fmul_rn(m, h.ibc1), den), h.neg_lr));
  }
}

template <int MODE>
__device__ __forceinline__ void adam_vec(float4& p, const float4& g, float4& m, float4& v,
                                         const Hyper& h) {
  adam_entry<MODE>(p.x, g.x, m.x, v.x, h);
  adam_entry<MODE>(p.y, g.y, m.y, v.y, h);
  adam_entry<MODE>(p.z, g.z, m.z, v.z, h);
  adam_entry<MODE>(p.w, g.w, m.w, v.w, h);
}

// Entries [start, end) of leaf `L`; start is a multiple of kChunk.
template <int MODE>
__device__ __forceinline__ void adam_range(const Leaf& L, long long start, long long end,
                                           const Hyper& h) {
  float* __restrict__ p = L.p;
  const float* __restrict__ g = L.g;
  float* __restrict__ mu = L.mu;
  float* __restrict__ nu = L.nu;
  if (MODE == kGradient && L.g_cols > 0) {
    // entry (m, r, c) of p's (.., g_rows, g_cols) reads g at (m, c, r): one
    // by one (the MLP weights, a few thousand entries a scene)
    const long long rows = L.g_rows, cols = L.g_cols, rc = rows * cols;
    for (long long i = start + threadIdx.x; i < end; i += kThreads) {
      const long long m = i / rc, rem = i - m * rc, r = rem / cols, c = rem - r * cols;
      float pi = __ldcs(p + i), mi = __ldcs(mu + i), vi = __ldcs(nu + i);
      adam_entry<MODE>(pi, __ldcs(g + m * rc + c * rows + r), mi, vi, h);
      __stcs(p + i, pi);
      __stcs(mu + i, mi);
      __stcs(nu + i, vi);
    }
    return;
  }
  uintptr_t a = (uintptr_t)p | (uintptr_t)mu | (uintptr_t)nu;
  if (MODE == kGradient) a |= (uintptr_t)g;
  const long long vend = (a & 15) == 0 ? start + ((end - start) & ~3LL) : start;
  constexpr long long kStep = 4LL * kThreads;
  for (long long base = start + 4LL * threadIdx.x; base < vend; base += kStep * kUnroll) {
    float4 P[kUnroll], G[kUnroll], M[kUnroll], V[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = base + k * kStep;
      if (i < vend) {
        if (MODE != kFrozen) P[k] = __ldcs(reinterpret_cast<const float4*>(p + i));
        G[k] = MODE == kGradient ? __ldcs(reinterpret_cast<const float4*>(g + i))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        M[k] = __ldcs(reinterpret_cast<const float4*>(mu + i));
        V[k] = __ldcs(reinterpret_cast<const float4*>(nu + i));
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = base + k * kStep;
      if (i < vend) {
        adam_vec<MODE>(P[k], G[k], M[k], V[k], h);
        if (MODE != kFrozen) __stcs(reinterpret_cast<float4*>(p + i), P[k]);
        __stcs(reinterpret_cast<float4*>(mu + i), M[k]);
        __stcs(reinterpret_cast<float4*>(nu + i), V[k]);
      }
    }
  }
  for (long long i = vend + threadIdx.x; i < end; i += kThreads) {
    float pi = MODE != kFrozen ? __ldcs(p + i) : 0.f;
    const float gi = MODE == kGradient ? __ldcs(g + i) : 0.f;
    float mi = __ldcs(mu + i), vi = __ldcs(nu + i);
    adam_entry<MODE>(pi, gi, mi, vi, h);
    if (MODE != kFrozen) __stcs(p + i, pi);
    __stcs(mu + i, mi);
    __stcs(nu + i, vi);
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
field_adam_kernel(const __grid_constant__ Table t) {
  for (int c = blockIdx.x; c < t.n_chunks; c += gridDim.x) {
    // the chunk's leaf: the last whose first chunk is at or before c
    int lo = 0, hi = t.n_leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.leaves[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
    }
    const Leaf& L = t.leaves[lo];
    const long long start = (long long)(c - L.chunk0) * kChunk;
    const long long end = start + kChunk < L.n ? start + kChunk : L.n;
    if (L.mode == kGradient) adam_range<kGradient>(L, start, end, t.h);
    else if (L.mode == kNoGradient) adam_range<kNoGradient>(L, start, end, t.h);
    else adam_range<kFrozen>(L, start, end, t.h);
  }
}

}  // namespace

extern "C" {

// Launch over the table's chunks with `grid` blocks on `stream`. Returns
// cudaGetLastError() after the launch (0 on success); the wrapper raises on
// anything else.
int field_adam_launch(const Table* t, int grid, void* stream) {
  if (t->n_leaves < 0 || t->n_leaves > kMaxLeaves || t->n_chunks < 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  if (t->n_chunks == 0) return 0;
  field_adam_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*t);
  return (int)cudaGetLastError();
}

}  // extern "C"
