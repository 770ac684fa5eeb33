// The multiresolution hash encoding in one launch: kernel B8, and the
// corner rows and weighted row gradients of its backward in a second one.
//
// Replaces no TPU kernel: the JAX package's hash_encode
// (instance_nerf_tpu/models/hashgrid.py) is plain jnp that XLA fuses on the
// TPU. The port's plain version (models/hashgrid.py:hash_encode_plain) makes
// a pass over the card's memory for every step of its index math: int64
// corners (N, L, 8, 3), their minimum with res - 1, the masked int64 hash
// products, XORs and modulo, the where, the level offsets, the cast, the
// gather, the (N * L, 8, 3) weights and their products. At a fleet's 524,288
// samples a step one int64 corner tensor is 1.6 GB.
//
// What bounds the encoding on Hopper: the rows read. A point reads 8 rows of
// F floats at each of its L levels, scattered over the level's table (a
// hashed level's rows are random; a fleet's 32 tables are 2 GB), so every
// row is a 32-byte sector of L2 or HBM, and writes L * F features. The index
// math is a few dozen integer operations a corner and needs no pass over
// memory at all.
//
// Design:
// - A block takes a tile of 32 consecutive points (kTile) and each warp one
//   level of the tile's points at a time: a warp's point loads are
//   coalesced, and at the coarse dense levels its 32 points' corners share
//   rows, one sector serving several lanes.
// - A lane starts its 8 corner gathers before it uses any of them, through
//   the read-only path: 8 loads in flight a lane.
// - The tile's features are staged in shared memory and written as one
//   contiguous run in the caller's layout ((B, N, L * F) for a fleet's (B,
//   N, 3) points: no transposes to a point-major order and back).
// - The levels' resolutions, scales and dense flags are kernel parameters
//   (__grid_constant__): nothing is uploaded a call. A table size that is a
//   power of two takes a mask for the modulo.
// - The backward recomputes each (point, scene, level)'s corners and weights
//   from the points alone (the forward saves nothing else) and writes the
//   int32 flat rows and grad * w in the (N, B, L, 8) layout that B3
//   (csrc/scatter_add.cu) consumes, B * L levels, trailing 8.
// - Arithmetic: x * (res - 1), floor, frac, 1 - frac and the weight products
//   with explicit round-to-nearest intrinsics, so that nvcc contracts
//   nothing into an FMA that the plain version does not have: the rows and
//   weights equal the plain version's bit for bit, and so do the backward's
//   products. The forward's 8-term sum is taken in the order of PyTorch's
//   CUDA sum over the corner axis (four accumulators from 0: corner c, then
//   c + 4, into the c-th; then the four in order).
// - A dense level clamps a corner below at 0 as well as above at res - 1: a
//   point below 0 would otherwise read outside its level's rows (the plain
//   version's callers clamp every point into [0, 1], where the two agree).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;  // levels a launch (hash_encode_cuda.MAX_LEVELS)
constexpr int kMaxFeatures = 8;  // floats a row (hash_encode_cuda.MAX_FEATURES)
constexpr int kTile = 32;        // points a forward block
constexpr int kThreads = 256;    // threads a block
constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;

}  // namespace

extern "C" {

// The launch's arguments, one kernel parameter (kernels/hash_encode_cuda.py:
// _Args mirrors it). Points are laid out (B, N, 3) and the table (B, L, T,
// F); B = 1 for one field.
struct EncodeArgs {
  const float* xyz;    // (B * N, 3)
  const float* table;  // (B * L * T, F)
  float* out;          // forward: (B * N, L * F)
  const float* grad;   // backward: the features' gradient, (B * N, L * F)
  int32_t* rows;       // backward: (N, B, L, 8) flat rows of the (B * L * T, F) table
  float* d_rows;       // backward: (N, B, L, 8, F), grad * w
  void* stream;
  long long scene_points;  // N
  int n_scenes, n_levels, n_features, table_size;
  uint32_t mask;  // T - 1 where T is a power of two, else 0
  int res[kMaxLevels];
  float scale[kMaxLevels];  // res - 1, in f32
  int dense[kMaxLevels];    // res^3 <= T
};

}  // extern "C"

namespace {

// The 8 corners of point (x, y, z) at level l: each corner's row in the
// level's table and its trilinear weight, corner c = 4 dx + 2 dy + dz.
__device__ __forceinline__ void corners(const EncodeArgs& a, int l, float x, float y, float z,
                                        uint32_t row[8], float w[8]) {
  const float s = a.scale[l];
  const int top = a.res[l] - 1;
  const float px = __fmul_rn(x, s), py = __fmul_rn(y, s), pz = __fmul_rn(z, s);
  const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  const float tx = __fsub_rn(px, fx), ty = __fsub_rn(py, fy), tz = __fsub_rn(pz, fz);
  const int ix = (int)fx, iy = (int)fy, iz = (int)fz;
  // min(i, res - 1) and min(i + 1, res - 1), with no overflow of i + 1
  int cx[2] = {min(ix, top), ix < top ? ix + 1 : top};
  int cy[2] = {min(iy, top), iy < top ? iy + 1 : top};
  int cz[2] = {min(iz, top), iz < top ? iz + 1 : top};
  const float wx[2] = {__fsub_rn(1.f, tx), tx};
  const float wy[2] = {__fsub_rn(1.f, ty), ty};
  const float wz[2] = {__fsub_rn(1.f, tz), tz};
  if (a.dense[l]) {
    const uint32_t r = (uint32_t)a.res[l];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      cx[k] = max(cx[k], 0);
      cy[k] = max(cy[k], 0);
      cz[k] = max(cz[k], 0);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c)
      row[c] = ((uint32_t)cx[c >> 2] * r + (uint32_t)cy[(c >> 1) & 1]) * r +
               (uint32_t)cz[c & 1];
  } else {
    const uint32_t hy[2] = {(uint32_t)cy[0] * kPrime1, (uint32_t)cy[1] * kPrime1};
    const uint32_t hz[2] = {(uint32_t)cz[0] * kPrime2, (uint32_t)cz[1] * kPrime2};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint32_t h = (uint32_t)cx[c >> 2] ^ hy[(c >> 1) & 1] ^ hz[c & 1];
      row[c] = a.mask ? (h & a.mask) : h % (uint32_t)a.table_size;
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c)
    w[c] = __fmul_rn(__fmul_rn(wx[c >> 2], wy[(c >> 1) & 1]), wz[c & 1]);
}

// A row of F floats, in the widest loads its alignment allows (the table is
// 16-byte aligned, so a row of F % 4 == 0 floats is too).
template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ src, float (&v)[F]) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int f = 0; f < F; f += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(src + f));
      v[f] = q.x; v[f + 1] = q.y; v[f + 2] = q.z; v[f + 3] = q.w;
    }
  } else if constexpr (F % 2 == 0) {
#pragma unroll
    for (int f = 0; f < F; f += 2) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(src + f));
      v[f] = q.x; v[f + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = __ldg(src + f);
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads)
hash_encode_kernel(const __grid_constant__ EncodeArgs a) {
  // the tile's features, a row of L * F + 1 floats a point (the extra float
  // keeps the lanes of a warp on distinct banks)
  extern __shared__ float tile[];
  const int L = a.n_levels, LF = L * F, stride = LF + 1;
  const long long n_points = a.scene_points * a.n_scenes;
  const long long first = (long long)blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p = first + lane;
  if (p < n_points) {
    const float x = a.xyz[3 * p], y = a.xyz[3 * p + 1], z = a.xyz[3 * p + 2];
    const long long scene = p / a.scene_points;
    for (int l = warp; l < L; l += kThreads / 32) {
      uint32_t row[8];
      float w[8];
      corners(a, l, x, y, z, row, w);
      const float* slab = a.table + (scene * L + l) * (long long)a.table_size * F;
      float v[8][F];
#pragma unroll
      for (int c = 0; c < 8; ++c) load_row<F>(slab + (long long)row[c] * F, v[c]);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float pair[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          pair[c] = __fadd_rn(__fadd_rn(0.f, __fmul_rn(v[c][f], w[c])),
                              __fmul_rn(v[c + 4][f], w[c + 4]));
        tile[lane * stride + l * F + f] =
            __fadd_rn(__fadd_rn(__fadd_rn(pair[0], pair[1]), pair[2]), pair[3]);
      }
    }
  }
  __syncthreads();
  const long long left = n_points - first;
  const int count = (int)(left < kTile ? left : kTile) * LF;
  float* out = a.out + first * LF;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int q = i / LF;
    out[i] = tile[q * stride + (i - q * LF)];
  }
}

// One thread a (point, scene, level), numbered (N, B, L) as B3 takes them.
template <int F>
__global__ void __launch_bounds__(kThreads)
hash_encode_grad_kernel(const __grid_constant__ EncodeArgs a) {
  const int L = a.n_levels, B = a.n_scenes;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= a.scene_points * B * L) return;
  const int l = (int)(t % L);
  const long long nb = t / L;
  const int b = (int)(nb % B);
  const long long p = b * a.scene_points + nb / B;  // the point in the caller's layout
  uint32_t row[8];
  float w[8];
  corners(a, l, a.xyz[3 * p], a.xyz[3 * p + 1], a.xyz[3 * p + 2], row, w);
  const uint32_t base = (uint32_t)(b * L + l) * (uint32_t)a.table_size;  // below 2^31
  int r[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) r[c] = (int)(base + row[c]);
  int4* rows = reinterpret_cast<int4*>(a.rows + t * 8);
  rows[0] = make_int4(r[0], r[1], r[2], r[3]);
  rows[1] = make_int4(r[4], r[5], r[6], r[7]);
  float g[F];
  const float* src = a.grad + p * L * F + l * F;
#pragma unroll
  for (int f = 0; f < F; ++f) g[f] = src[f];
  float d[8 * F];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int f = 0; f < F; ++f) d[c * F + f] = __fmul_rn(g[f], w[c]);
  // 8 * F floats from float 8 * F * t: 16-byte vectors, all aligned
  float4* dst = reinterpret_cast<float4*>(a.d_rows + t * 8 * F);
#pragma unroll
  for (int k = 0; k < 2 * F; ++k)
    dst[k] = make_float4(d[4 * k], d[4 * k + 1], d[4 * k + 2], d[4 * k + 3]);
}

bool valid(const EncodeArgs& a) {
  return a.scene_points >= 0 && a.n_scenes > 0 && a.n_levels > 0 &&
         a.n_levels <= kMaxLevels && a.n_features > 0 && a.n_features <= kMaxFeatures &&
         a.table_size > 0 &&
         (long long)a.n_scenes * a.n_levels * a.table_size < (1LL << 31);
}

template <int F>
int launch(const EncodeArgs& a, bool backward) {
  cudaStream_t s = static_cast<cudaStream_t>(a.stream);
  const long long n_points = a.scene_points * a.n_scenes;
  if (n_points == 0) return 0;
  if (backward) {
    const long long threads = n_points * a.n_levels;
    hash_encode_grad_kernel<F><<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
                                 s>>>(a);
  } else {
    const size_t smem = (size_t)kTile * (a.n_levels * F + 1) * sizeof(float);
    hash_encode_kernel<F><<<(unsigned)((n_points + kTile - 1) / kTile), kThreads, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}

int dispatch(const EncodeArgs* args, bool backward) {
  const EncodeArgs& a = *args;
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  switch (a.n_features) {
    case 1: return launch<1>(a, backward);
    case 2: return launch<2>(a, backward);
    case 3: return launch<3>(a, backward);
    case 4: return launch<4>(a, backward);
    case 5: return launch<5>(a, backward);
    case 6: return launch<6>(a, backward);
    case 7: return launch<7>(a, backward);
    default: return launch<8>(a, backward);
  }
}

}  // namespace

extern "C" {

// The features of every point (out), on a.stream. Returns cudaGetLastError()
// after the launch (0 on success); the wrapper raises on anything else.
int hash_encode_launch(const EncodeArgs* args) { return dispatch(args, false); }

// The backward's rows and d_rows from the points and the features' gradient.
int hash_encode_grad_launch(const EncodeArgs* args) { return dispatch(args, true); }

}  // extern "C"
