// Kernel 2: 2x2 / stride-2 max pool on NHWC memory, forward.
//
// Replaces semantic_pyramid_for_image_generation_tpu/ops/pallas/pool.py::_fwd
// (kernel _mp_fwd_kernel), reached through max_pool_2x2_pallas. The TPU
// kernel paired rows through a bitcast view and selected even / odd columns
// with 0/1 matrices on the MXU, because Mosaic cannot slice the minor-most
// dimension; on Hopper every thread simply reads its four window elements.
//
// Bound: bytes. Each input element is read once and each output written once
// (1.25 x input bytes moved, one compare per input element), so the card's
// memory rate is the limit. Design: one thread per (output pixel, VEC
// consecutive channels). C is innermost in NHWC, so neighbouring threads read
// neighbouring 16-byte packs (float x4, bf16 x8) and every warp access is
// coalesced; a grid-stride loop covers any batch, any even H and W and any C.
//
// Exactness: the result is one of the four inputs, chosen in the order of the
// JAX pairwise form (rows first, then columns), so it is bitwise equal to the
// plain version in both dtypes. NaN propagates as in jnp.maximum and
// torch.maximum (fmaxf would drop it).
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
