// Volume compositing in one launch: kernel B9, and its backward in a second
// one.
//
// Replaces no TPU kernel: the JAX package's composite
// (instance_nerf_tpu/models/render.py) is plain jnp that XLA fuses on the
// TPU. The port's plain version (models/render.py:composite_plain) is a chain
// of about twenty PyTorch operations (clamp, exp, the mask and valid
// products, 1 - exp(-sigma dt), cumprod, cat, three weighted sums, the
// instance tail), each a launch and a pass over the samples, and as many
// again in its backward. Worse, cumprod's backward reads (input == 0).any()
// back to the host to pick its formula: once a step the host waits for the
// card's whole queue, and the card then idles while autograd launches the
// rest of the backward.
//
// What bounds compositing on Hopper: bytes, and few of them. A sample reads
// its raw density (the head's strided column), 3 colours, t, dt and the
// occupancy mask, and writes its weight (and, when a gradient will be taken,
// its transmittance for the backward); a ray reads valid and writes rgb,
// depth, acc and the instance logits. At a fleet's 524,288 samples a step
// that is about 13 MB, 4 us at 3.35 TB/s: the chain's launches and the
// read-back cost far more than the bytes.
//
// Design:
// - One thread a ray. K comes from the shape; the inputs come in the
//   callers' layouts through element strides ((S, R, K) for a fleet's
//   leading scene axis S), so the head's sigma_raw column h[..., 0] and the
//   expanded dt are read in place, with no copy launch. A ray's samples live
//   in the thread's registers (K <= 32, every trainer's K) or its local
//   memory (K <= 128, the uncompacted renders).
// - The forward writes each sample's exclusive transmittance T when a
//   gradient will be taken. The backward takes PyTorch's formula for
//   cumprod's gradient where no factor is 0 (1 - alpha + 1e-10 never is):
//   the reversed cumulative sum of P * dP over the factor, T[k + 1] being
//   the inclusive product P[k]. Nothing is read back to the host.
// - The instance logits composite through the weights without gradient, and
//   class 0 gets 10 * max(1 - acc, 0), as the plain version does; their
//   gradient is the weights times the logits' gradient.
// - Arithmetic: the plain version's operations, each rounded as PyTorch's
//   CUDA kernels round it, with explicit round-to-nearest intrinsics so that
//   nvcc contracts nothing into an FMA. sigma_raw, rgb and the logits are f32
//   or bf16 (one type for the three): the activation exp(clamp(sigma_raw)) is
//   rounded to that type, the products with the f32 mask, dt, t and weights
//   are f32, and each gradient is rounded to its input's type where autograd
//   rounds it (sigma_raw's before and after the exp's backward).
// - Order: the products and sums are taken in the order of PyTorch's CUDA
//   kernels on the plain version's tensors, so that in bf16 no gradient
//   lands on the other side of a rounding boundary from the plain version's:
//   cumprod and the backward's reversed cumsum as its inner-dimension scan
//   (ScanUtils.cuh: Sklansky's scan over chunks of 2 * 2^scan_log_threads
//   columns, each chunk's first entry combined with the total before it);
//   the sums over the samples as its reduction (Reduce.cuh: a lane takes the
//   samples the reduction's configuration gives it into 4 accumulators in
//   turn, the accumulators are added in order, then the lanes pairwise at
//   halving offsets). The wrapper computes the configurations from the
//   shapes as PyTorch does (kernels/composite_cuda.py: scan_log_threads,
//   sum_lanes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // rays a block
constexpr int kMaxLanes = 64;  // lanes of PyTorch's reductions at K <= 128

}  // namespace

extern "C" {

// The launch's arguments, one kernel parameter (kernels/composite_cuda.py:
// _Args mirrors it). S scenes of R rays of K samples; a stride is in
// elements of its tensor.
struct CompositeArgs {
  const void* sigma;   // (S, R, K) raw densities, f32 or bf16
  const void* rgb;     // (S, R, K, 3), sigma's type
  const void* logits;  // (S, R, K, I), sigma's type; null: no instance output
  const float* t;      // (S, R, K)
  const float* dt;     // (S, R, K)
  const float* mask;   // (S, R, K); null: every sample kept
  const float* valid;  // (S, R); null: every ray valid
  float* out_rgb;      // (S * R, 3)
  float* depth;        // (S * R,)
  float* acc;          // (S * R,)
  float* inst;         // (S * R, I)
  float* weights;      // (S * R, K)
  float* trans;        // (S * R, K) exclusive transmittance; null: not kept
  const float* g_rgb;      // backward: the outputs' gradients, contiguous;
  const float* g_depth;    // null where none arrived
  const float* g_acc;
  const float* g_weights;
  const float* g_inst;
  void* d_sigma;   // backward: (S * R * K,) in sigma's type; null: not wanted
  void* d_rgb;     // (S * R * K, 3); null: not wanted
  void* d_logits;  // (S * R * K, I); null: not wanted
  void* stream;
  long long n_scenes, n_rays;
  long long sigma_stride[3], rgb_stride[4], logits_stride[4], t_stride[3], dt_stride[3],
      mask_stride[3], valid_stride[2];
  int n_samples, n_classes;  // K, I
  int bf16;                  // sigma, rgb and logits in bf16, else f32
  int scan_log_threads;      // PyTorch's scan: chunks of 2 << this columns
  int sum_lanes, sum_vectorized;  // PyTorch's sum over a ray's K contiguous samples
  int inst_lanes;            // its sum over the samples of the (K, I) logits
};

}  // extern "C"

namespace {

template <typename D>
__device__ __forceinline__ float load(const void* p, long long i) {
  if constexpr (sizeof(D) == 2)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  else
    return static_cast<const float*>(p)[i];
}

template <typename D>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(D) == 2)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

template <typename D>
__device__ __forceinline__ void store(void* p, long long i, float x) {
  if constexpr (sizeof(D) == 2)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(p)[i] = x;
}

// A ray's view of the inputs: scene s, ray r.
struct Ray {
  long long sigma, rgb, logits, t, dt, mask;  // offsets of sample 0
  float valid;
};

__device__ __forceinline__ Ray ray_of(const CompositeArgs& a, long long i) {
  const long long s = i / a.n_rays, r = i - s * a.n_rays;
  Ray y;
  y.sigma = s * a.sigma_stride[0] + r * a.sigma_stride[1];
  y.rgb = s * a.rgb_stride[0] + r * a.rgb_stride[1];
  y.logits = s * a.logits_stride[0] + r * a.logits_stride[1];
  y.t = s * a.t_stride[0] + r * a.t_stride[1];
  y.dt = s * a.dt_stride[0] + r * a.dt_stride[1];
  y.mask = s * a.mask_stride[0] + r * a.mask_stride[1];
  y.valid = a.valid ? a.valid[s * a.valid_stride[0] + r * a.valid_stride[1]] : 1.f;
  return y;
}

// What the forward makes of sample k's density.
struct Act {
  float raw, mask, dt;
  float sigma;  // exp(clamp(raw, -15, 15)), rounded to the inputs' type
  float e;      // exp(-(sigma * mask) * dt)
  float alpha;  // 1 - e
};

// Sample k of ray y. A missing mask reads 1: sigma * 1 is sigma exactly.
template <typename D>
__device__ __forceinline__ Act activate(const CompositeArgs& a, const Ray& y, int k) {
  Act v;
  v.raw = load<D>(a.sigma, y.sigma + k * a.sigma_stride[2]);
  v.mask = a.mask ? a.mask[y.mask + k * a.mask_stride[2]] : 1.f;
  v.dt = a.dt[y.dt + k * a.dt_stride[2]];
  // torch.clamp: NaN stays NaN
  const float c = isnan(v.raw) ? v.raw : fminf(fmaxf(v.raw, -15.f), 15.f);
  v.sigma = round_to<D>(expf(c));
  v.e = expf(__fmul_rn(-__fmul_rn(v.sigma, v.mask), v.dt));
  v.alpha = __fsub_rn(1.f, v.e);
  return v;
}

template <typename D>
__device__ __forceinline__ float colour(const CompositeArgs& a, const Ray& y, int k, int c) {
  return load<D>(a.rgb, y.rgb + k * a.rgb_stride[2] + c * a.rgb_stride[3]);
}

template <typename D>
__device__ __forceinline__ float logit(const CompositeArgs& a, const Ray& y, int k, int c) {
  return load<D>(a.logits, y.logits + k * a.logits_stride[2] + c * a.logits_stride[3]);
}

// The cumprod's factor 1 - alpha + 1e-10 (never 0).
__device__ __forceinline__ float factor(float alpha) {
  return __fadd_rn(__fsub_rn(1.f, alpha), 1e-10f);
}

template <bool MUL>
__device__ __forceinline__ float combine(float x, float y) {
  return MUL ? __fmul_rn(x, y) : __fadd_rn(x, y);
}

// PyTorch's inclusive scan of x[0, K) in place (tensor_kernel_scan_innermost_dim
// with 2^log_threads threads a row): chunks of W = 2^(log_threads + 1)
// columns; a chunk's first entry combined with the total of the chunks
// before it, then Sklansky's levels s = 1, 2, 4, ...: x[t] op= x[(t with its
// low log2(2s) bits set to s - 1)] for every t with bit s set.
template <int KM, bool MUL>
__device__ __forceinline__ void scan(float (&x)[KM], int K, int log_threads) {
  const int W = 2 << log_threads;
  if (W >= KM) {  // one chunk: indices known at compile time
#pragma unroll
    for (int s = 1; s < KM; s <<= 1)
#pragma unroll
      for (int t = 0; t < KM; ++t)
        if ((t & s) && t < K) x[t] = combine<MUL>(x[t], x[(t & ~(2 * s - 1)) | (s - 1)]);
    return;
  }
  float total = MUL ? 1.f : 0.f;
  for (int c0 = 0; c0 < K; c0 += W) {
    if (c0 > 0) x[c0] = combine<MUL>(x[c0], total);
    for (int s = 1; s < W; s <<= 1)
      for (int t = s; t < W && c0 + t < K; ++t)
        if (t & s) x[c0 + t] = combine<MUL>(x[c0 + t], x[c0 + ((t & ~(2 * s - 1)) | (s - 1))]);
    if (c0 + W <= K) total = x[c0 + W - 1];
  }
}

// PyTorch's sum of x[0, K) (ReduceOp with `lanes` lanes a row): lane l takes
// samples l, l + lanes, ... (or, vectorized, the 4-sample groups l, l +
// lanes, ...) into accumulators 0, 1, 2, 3, 0, ... in turn; a lane's value
// is ((a0 + a1) + a2) + a3, and the lanes are added pairwise at offsets
// lanes / 2, lanes / 4, ..., 1.
template <int KM>
__device__ __forceinline__ float sum(const float (&x)[KM], int K, int lanes, bool vectorized) {
  float lane[kMaxLanes < KM ? kMaxLanes : KM];
  for (int l = 0; l < lanes; ++l) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (vectorized) {
      for (int e = 4 * l; e + 3 < K; e += 4 * lanes)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = __fadd_rn(acc[q], x[e + q]);
    } else {
      for (int e = l, j = 0; e < K; e += lanes, ++j) acc[j & 3] = __fadd_rn(acc[j & 3], x[e]);
    }
    lane[l] = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
  }
  for (int off = lanes >> 1; off > 0; off >>= 1)
    for (int l = 0; l < off; ++l) lane[l] = __fadd_rn(lane[l], lane[l + off]);
  return lane[0];
}

template <typename D, int KM>
__global__ void __launch_bounds__(kThreads)
composite_kernel(const __grid_constant__ CompositeArgs a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n_scenes * a.n_rays) return;
  const Ray y = ray_of(a, i);
  const int K = a.n_samples;
  float alpha[KM], w[KM], x[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    if (k >= K) break;
    alpha[k] = activate<D>(a, y, k).alpha;
    w[k] = factor(alpha[k]);
  }
  scan<KM, true>(w, K, a.scan_log_threads);  // w: the inclusive products P
  // w = (alpha T) valid, T[k] = P[k - 1]: last sample first, so P[k - 1] is there
#pragma unroll
  for (int k = KM - 1; k >= 0; --k) {
    if (k >= K) continue;
    const float T = k ? w[k - 1] : 1.f;
    if (a.trans) a.trans[i * K + k] = T;
    w[k] = __fmul_rn(__fmul_rn(alpha[k], T), y.valid);
    a.weights[i * K + k] = w[k];
  }
  // rgb: one lane, the samples into 4 accumulators in turn
  for (int c = 0; c < 3; ++c) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      if (k >= K) break;
      acc[k & 3] = __fadd_rn(acc[k & 3], __fmul_rn(w[k], colour<D>(a, y, k, c)));
    }
    a.out_rgb[3 * i + c] = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
  }
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    if (k >= K) break;
    x[k] = __fmul_rn(w[k], a.t[y.t + k * a.t_stride[2]]);
  }
  a.depth[i] = sum(x, K, a.sum_lanes, a.sum_vectorized);
  const float acc = sum(w, K, a.sum_lanes, a.sum_vectorized);
  a.acc[i] = acc;
  if (!a.logits) return;
  // max(1 - acc, 0) * bg with bg = (10, 0, 0, ...); torch.clamp keeps NaN
  const float res = __fsub_rn(1.f, acc);
  const float bg = isnan(res) ? res : fmaxf(res, 0.f);
  for (int c = 0; c < a.n_classes; ++c) {
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      if (k >= K) break;
      x[k] = __fmul_rn(w[k], logit<D>(a, y, k, c));
    }
    const float s = sum(x, K, a.inst_lanes, false);
    a.inst[i * a.n_classes + c] = __fadd_rn(s, __fmul_rn(bg, c == 0 ? 10.f : 0.f));
  }
}

template <typename D, int KM>
__global__ void __launch_bounds__(kThreads)
composite_grad_kernel(const __grid_constant__ CompositeArgs a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n_scenes * a.n_rays) return;
  const Ray y = ray_of(a, i);
  const int K = a.n_samples, I = a.n_classes;
  const float gr = a.g_rgb ? a.g_rgb[3 * i] : 0.f;
  const float gg = a.g_rgb ? a.g_rgb[3 * i + 1] : 0.f;
  const float gb = a.g_rgb ? a.g_rgb[3 * i + 2] : 0.f;
  const float gd = a.g_depth ? a.g_depth[i] : 0.f;
  const float ga = a.g_acc ? a.g_acc[i] : 0.f;
  const float* trans = a.trans + i * K;
  // rgb's and the logits' gradients: the weights times the outputs'
  if (a.d_rgb || a.d_logits) {
    for (int k = 0; k < K; ++k) {
      const float w = __fmul_rn(__fmul_rn(activate<D>(a, y, k).alpha, trans[k]), y.valid);
      const long long ik = i * K + k;
      if (a.d_rgb) {
        store<D>(a.d_rgb, 3 * ik, __fmul_rn(gr, w));
        store<D>(a.d_rgb, 3 * ik + 1, __fmul_rn(gg, w));
        store<D>(a.d_rgb, 3 * ik + 2, __fmul_rn(gb, w));
      }
      if (a.d_logits)
        for (int c = 0; c < I; ++c)
          store<D>(a.d_logits, ik * I + c, __fmul_rn(a.g_inst[i * I + c], w));
    }
  }
  if (!a.d_sigma) return;
  // dw0: the gradient of alpha T (w = (alpha T) valid), from rgb (its 3
  // channels summed as PyTorch sums a row of 3: (0 + 2) + 1), depth, acc,
  // then the weights themselves; x: P[k] dP[k], flipped (x[K - 1 - k]), with
  // dP[k] = dT[k + 1] and dP[K - 1] = 0
  float alpha[KM], dw0[KM], x[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    if (k >= K) break;
    alpha[k] = activate<D>(a, y, k).alpha;
    float dw = 0.f;
    if (a.g_rgb)
      dw = __fadd_rn(__fadd_rn(__fmul_rn(gr, colour<D>(a, y, k, 0)),
                               __fmul_rn(gb, colour<D>(a, y, k, 2))),
                     __fmul_rn(gg, colour<D>(a, y, k, 1)));
    if (a.g_depth) dw = __fadd_rn(dw, __fmul_rn(gd, a.t[y.t + k * a.t_stride[2]]));
    if (a.g_acc) dw = __fadd_rn(dw, ga);
    if (a.g_weights) dw = __fadd_rn(dw, a.g_weights[i * K + k]);
    dw0[k] = __fmul_rn(dw, y.valid);
  }
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    if (k >= K) break;
    const float P = k + 1 < K ? trans[k + 1] : __fmul_rn(trans[k], factor(alpha[k]));
    const float dP = k + 1 < K ? __fmul_rn(dw0[k + 1], alpha[k + 1]) : 0.f;
    x[K - 1 - k] = __fmul_rn(P, dP);
  }
  scan<KM, false>(x, K, a.scan_log_threads);  // x[K - 1 - k]: the sum over j >= k
  for (int k = 0; k < K; ++k) {
    const Act v = activate<D>(a, y, k);
    const float dalpha =
        __fsub_rn(__fmul_rn(dw0[k], trans[k]), __fdiv_rn(x[K - 1 - k], factor(v.alpha)));
    const float de = -dalpha;                                 // alpha = 1 - e
    const float dsm = -__fmul_rn(__fmul_rn(de, v.e), v.dt);  // e = exp(-(sigma m) dt)
    const float dsig = round_to<D>(__fmul_rn(dsm, v.mask));
    const float dc = round_to<D>(__fmul_rn(dsig, v.sigma));  // exp's backward
    const bool inside = v.raw >= -15.f && v.raw <= 15.f;     // clamp's backward
    store<D>(a.d_sigma, i * K + k, inside ? dc : 0.f);
  }
}

bool valid_args(const CompositeArgs& a, bool backward) {
  const bool outputs = backward ? a.trans != nullptr
                                : a.out_rgb && a.depth && a.acc && a.weights &&
                                      (!a.logits || a.inst);
  return outputs && a.sigma && a.rgb && a.t && a.dt && a.n_scenes >= 0 && a.n_rays >= 0 &&
         a.n_samples > 0 && a.n_samples <= 128 && a.n_classes >= 0 &&
         a.scan_log_threads >= 4 && a.scan_log_threads <= 9 && a.sum_lanes > 0 &&
         a.sum_lanes <= kMaxLanes && a.inst_lanes > 0 && a.inst_lanes <= kMaxLanes;
}

template <typename D, int KM>
int launch(const CompositeArgs& a, bool backward) {
  cudaStream_t s = static_cast<cudaStream_t>(a.stream);
  const long long rays = a.n_scenes * a.n_rays;
  if (rays == 0) return 0;
  const unsigned blocks = (unsigned)((rays + kThreads - 1) / kThreads);
  if (backward)
    composite_grad_kernel<D, KM><<<blocks, kThreads, 0, s>>>(a);
  else
    composite_kernel<D, KM><<<blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename D>
int launch_k(const CompositeArgs& a, bool backward) {
  return a.n_samples <= 32 ? launch<D, 32>(a, backward) : launch<D, 128>(a, backward);
}

int dispatch(const CompositeArgs* args, bool backward) {
  const CompositeArgs& a = *args;
  if (!valid_args(a, backward)) return (int)cudaErrorInvalidValue;
  return a.bf16 ? launch_k<__nv_bfloat16>(a, backward) : launch_k<float>(a, backward);
}

}  // namespace

extern "C" {

// The forward's outputs (out_rgb, depth, acc, inst, weights, and trans where
// given), on a.stream. Returns cudaGetLastError() after the launch (0 on
// success); the wrapper raises on anything else.
int composite_launch(const CompositeArgs* args) { return dispatch(args, false); }

// The gradients d_sigma, d_rgb and d_logits (each where given) from the
// inputs, the forward's trans and the outputs' gradients.
int composite_grad_launch(const CompositeArgs* args) { return dispatch(args, true); }

}  // extern "C"
