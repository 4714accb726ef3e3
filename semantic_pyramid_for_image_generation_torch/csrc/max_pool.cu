// Kernel 2: 2x2 / stride-2 max pool on NHWC memory, forward, and Kernel 4,
// its backward.
//
// Kernel 2 replaces semantic_pyramid_for_image_generation_tpu/ops/pallas/
// pool.py::_fwd (kernel _mp_fwd_kernel), reached through max_pool_2x2_pallas.
// The TPU kernel paired rows through a bitcast view and selected even / odd
// columns with 0/1 matrices on the MXU, because Mosaic cannot slice the
// minor-most dimension; on Hopper every thread simply reads its four window
// elements.
//
// Kernel 4 replaces ops/pallas/pool.py::_mp_vjp_bwd (kernel _mp_bwd_kernel).
// It recomputes the forward from x and routes the output gradient g with
// JAX's balanced-eq maximum rule (_balanced): first at the column level
// between the two row maxima, then at the row level inside each column. A
// sole maximum takes all of g, each side of a tie takes g/2, at each pairwise
// level. Ties are common (post-ReLU zeros, 0/1 masks), so this is the rule
// that matters, not an edge case; F.max_pool2d's backward routes g to one
// index and breaks it.
//
// Bound: bytes. The forward reads each input element once and writes a
// quarter as many (1.25 x input bytes, one compare per input element). The
// backward reads x and g and writes gx (2.25 x input bytes, a few compares
// and at most two exact halvings per element). The card's memory rate is the
// limit of both. Design: one thread per (output pixel, VEC consecutive
// channels). C is innermost in NHWC, so neighbouring threads read
// neighbouring 16-byte packs (float x4, bf16 x8) and every warp access is
// coalesced; a grid-stride loop covers any batch, any even H and W and any C.
// The 2x2 windows are disjoint, so the backward needs no atomics and no
// accumulation: each thread writes its own four gx packs.
//
// Exactness: the forward result is one of the four inputs, chosen in the
// order of the JAX pairwise form (rows first, then columns), so it is bitwise
// equal to the plain version in both dtypes. NaN propagates as in
// jnp.maximum and torch.maximum (fmaxf would drop it); a window holding a NaN
// gets no gradient, since NaN equals nothing. The backward computes in fp32
// (bf16 -> fp32 is exact) and g/2, g/4 are exact, so gx is bitwise equal to
// the plain version and to JAX's max-pool VJP in fp32 and bf16.
#include "common.cuh"

namespace spig {
namespace {

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  const float fa = to_f32(a), fb = to_f32(b);
  return (fa > fb || fa != fa) ? a : b;
}

template <typename T, int VEC>
__global__ void max_pool_2x2_kernel(const T* __restrict__ x, T* __restrict__ y,
                                    int batch, int h, int w, int c) {
  const int ho = h / 2, wo = w / 2, cv = c / VEC;
  const size_t total = static_cast<size_t>(batch) * ho * wo * cv;
  const size_t row = static_cast<size_t>(w) * c;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int ci = static_cast<int>(i % cv);
    size_t t = i / cv;
    const int ox = static_cast<int>(t % wo);
    t /= wo;
    const int oy = static_cast<int>(t % ho);
    const size_t b = t / ho;
    const T* p00 = x + ((b * h + 2 * oy) * w + 2 * ox) * c + ci * VEC;
    using P = Pack<T, VEC>;
    const P x00 = *reinterpret_cast<const P*>(p00);
    const P x01 = *reinterpret_cast<const P*>(p00 + c);
    const P x10 = *reinterpret_cast<const P*>(p00 + row);
    const P x11 = *reinterpret_cast<const P*>(p00 + row + c);
    P out;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      out.v[e] = nan_max(nan_max(x00.v[e], x10.v[e]),
                         nan_max(x01.v[e], x11.v[e]));
    }
    *reinterpret_cast<P*>(y + i * VEC) = out;
  }
}

__device__ __forceinline__ float nan_max_f32(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// JAX's maximum transpose rule: all of g on a sole maximum, g/2 on a tie.
__device__ __forceinline__ float balanced(bool eq_self, bool eq_other,
                                          float g) {
  return eq_self ? (eq_other ? g * 0.5f : g) : 0.0f;
}

template <typename T, int VEC>
__global__ void max_pool_2x2_backward_kernel(const T* __restrict__ x,
                                             const T* __restrict__ g,
                                             T* __restrict__ gx, int batch,
                                             int h, int w, int c) {
  const int ho = h / 2, wo = w / 2, cv = c / VEC;
  const size_t total = static_cast<size_t>(batch) * ho * wo * cv;
  const size_t row = static_cast<size_t>(w) * c;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int ci = static_cast<int>(i % cv);
    size_t t = i / cv;
    const int ox = static_cast<int>(t % wo);
    t /= wo;
    const int oy = static_cast<int>(t % ho);
    const size_t b = t / ho;
    const size_t o00 = ((b * h + 2 * oy) * w + 2 * ox) * c + ci * VEC;
    using P = Pack<T, VEC>;
    const P x00 = *reinterpret_cast<const P*>(x + o00);
    const P x01 = *reinterpret_cast<const P*>(x + o00 + c);
    const P x10 = *reinterpret_cast<const P*>(x + o00 + row);
    const P x11 = *reinterpret_cast<const P*>(x + o00 + row + c);
    const P gp = *reinterpret_cast<const P*>(g + i * VEC);
    P g00, g01, g10, g11;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float a00 = to_f32(x00.v[e]), a01 = to_f32(x01.v[e]);
      const float a10 = to_f32(x10.v[e]), a11 = to_f32(x11.v[e]);
      // the forward: rows paired per column, then the two columns
      const float m0 = nan_max_f32(a00, a10), m1 = nan_max_f32(a01, a11);
      const float out = nan_max_f32(m0, m1);
      const float gv = to_f32(gp.v[e]);
      // column level, then row level inside each column
      const float ge = balanced(m0 == out, m1 == out, gv);
      const float go = balanced(m1 == out, m0 == out, gv);
      g00.v[e] = from_f32<T>(balanced(a00 == m0, a10 == m0, ge));
      g10.v[e] = from_f32<T>(balanced(a10 == m0, a00 == m0, ge));
      g01.v[e] = from_f32<T>(balanced(a01 == m1, a11 == m1, go));
      g11.v[e] = from_f32<T>(balanced(a11 == m1, a01 == m1, go));
    }
    *reinterpret_cast<P*>(gx + o00) = g00;
    *reinterpret_cast<P*>(gx + o00 + c) = g01;
    *reinterpret_cast<P*>(gx + o00 + row) = g10;
    *reinterpret_cast<P*>(gx + o00 + row + c) = g11;
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, void* y, int batch, int h, int w, int c,
                   cudaStream_t stream) {
  constexpr int kThreads = 256;
  const size_t total =
      static_cast<size_t>(batch) * (h / 2) * (w / 2) * (c / VEC);
  max_pool_2x2_kernel<T, VEC><<<grid_for(total, kThreads), kThreads, 0,
                                stream>>>(static_cast<const T*>(x),
                                          static_cast<T*>(y), batch, h, w, c);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_backward(const void* x, const void* g, void* gx, int batch,
                            int h, int w, int c, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const size_t total =
      static_cast<size_t>(batch) * (h / 2) * (w / 2) * (c / VEC);
  max_pool_2x2_backward_kernel<T, VEC>
      <<<grid_for(total, kThreads), kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(g),
          static_cast<T*>(gx), batch, h, w, c);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spig

// x: (batch, h, w, c) contiguous; y: (batch, h/2, w/2, c) contiguous.
extern "C" int spig_max_pool_2x2(const void* x, void* y, int batch, int h,
                                 int w, int c, int dtype, void* stream) {
  using namespace spig;
  if (batch < 1 || h < 2 || w < 2 || c < 1 || h % 2 || w % 2) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  const bool packed = aligned_to(x, 16) && aligned_to(y, 16);
  if (dtype == kFloat32) {
    if (packed && c % 4 == 0) return launch<float, 4>(x, y, batch, h, w, c, s);
    return launch<float, 1>(x, y, batch, h, w, c, s);
  }
  if (dtype == kBFloat16) {
    if (packed && c % 8 == 0) {
      return launch<__nv_bfloat16, 8>(x, y, batch, h, w, c, s);
    }
    return launch<__nv_bfloat16, 1>(x, y, batch, h, w, c, s);
  }
  return cudaErrorInvalidValue;
}

// x: (batch, h, w, c) contiguous; g: (batch, h/2, w/2, c) contiguous;
// gx: (batch, h, w, c) contiguous, every element written.
extern "C" int spig_max_pool_2x2_backward(const void* x, const void* g,
                                          void* gx, int batch, int h, int w,
                                          int c, int dtype, void* stream) {
  using namespace spig;
  if (batch < 1 || h < 2 || w < 2 || c < 1 || h % 2 || w % 2) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  const bool packed = aligned_to(x, 16) && aligned_to(g, 16) &&
                      aligned_to(gx, 16);
  if (dtype == kFloat32) {
    if (packed && c % 4 == 0) {
      return launch_backward<float, 4>(x, g, gx, batch, h, w, c, s);
    }
    return launch_backward<float, 1>(x, g, gx, batch, h, w, c, s);
  }
  if (dtype == kBFloat16) {
    if (packed && c % 8 == 0) {
      return launch_backward<__nv_bfloat16, 8>(x, g, gx, batch, h, w, c, s);
    }
    return launch_backward<__nv_bfloat16, 1>(x, g, gx, batch, h, w, c, s);
  }
  return cudaErrorInvalidValue;
}
