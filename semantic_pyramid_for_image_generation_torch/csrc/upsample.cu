// Kernel 3: 2x bilinear upsample with align_corners=True on NHWC memory,
// forward (nn.UpsamplingBilinear2d(scale_factor=2)).
//
// Replaces semantic_pyramid_for_image_generation_tpu/ops/pallas/resize.py::
// _forward (kernels _resize_kernel / _resize_kernel_small_c), reached through
// upsample_align_corners_pallas. The TPU kernel applied dense (out, in)
// interpolation matrices A_h x A_w^T on the MXU. A row of those matrices has
// at most two non-zeros, so on Hopper each output is a 2-tap stencil in each
// axis: four input reads and three weighted sums, no matrix.
//
// Bound: bytes. Every output element needs 4 reads that mostly hit in L1/L2
// and ~6 flops; the unique traffic is the input once plus the output (4x the
// input) once. Design: one thread per (output pixel, VEC consecutive
// channels); C is innermost, so a warp's four loads and its store are each
// coalesced 16-byte packs (float x4, bf16 x8). A grid-stride loop covers any
// shape.
//
// Numerics: the source coordinate i * (in - 1) / (out - 1) is taken in double
// with the same floor and clamp as ops/resize.py::
// _bilinear_matrix_align_corners (in == 1 gives weight 1 on row 0), and the
// sum runs H pass first, then W pass, as the matrix form does. fp32 agrees
// with the matrix form to fp32 rounding (not bitwise: FMA contraction and the
// zero terms of the dense product differ). bf16 is read into fp32 and rounded
// once at the store; the JAX bf16 form rounds between its two passes.
#include "common.cuh"

namespace spig {
namespace {

struct Taps {
  int i0, i1;
  float w0, w1;
};

// The two non-zeros of row `o` of the align-corners interpolation matrix.
__device__ __forceinline__ Taps taps(int o, int in, double scale) {
  const double src = o * scale;
  Taps t;
  t.i0 = static_cast<int>(floor(src));
  t.i1 = min(t.i0 + 1, in - 1);
  const double frac = src - t.i0;
  t.w0 = static_cast<float>(1.0 - frac);
  t.w1 = static_cast<float>(frac);
  return t;
}

template <typename T, int VEC>
__global__ void upsample_2x_kernel(const T* __restrict__ x, T* __restrict__ y,
                                   int batch, int h, int w, int c,
                                   double scale_h, double scale_w) {
  const int ho = 2 * h, wo = 2 * w, cv = c / VEC;
  const size_t total = static_cast<size_t>(batch) * ho * wo * cv;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int ci = static_cast<int>(i % cv);
    size_t t = i / cv;
    const int ox = static_cast<int>(t % wo);
    t /= wo;
    const int oy = static_cast<int>(t % ho);
    const size_t b = t / ho;
    const Taps ty = taps(oy, h, scale_h);
    const Taps tx = taps(ox, w, scale_w);
    const T* base = x + b * h * w * c + ci * VEC;
    using P = Pack<T, VEC>;
    const P a00 = *reinterpret_cast<const P*>(base + (static_cast<size_t>(ty.i0) * w + tx.i0) * c);
    const P a10 = *reinterpret_cast<const P*>(base + (static_cast<size_t>(ty.i1) * w + tx.i0) * c);
    const P a01 = *reinterpret_cast<const P*>(base + (static_cast<size_t>(ty.i0) * w + tx.i1) * c);
    const P a11 = *reinterpret_cast<const P*>(base + (static_cast<size_t>(ty.i1) * w + tx.i1) * c);
    P out;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      // H pass at the two source columns, then the W pass
      const float c0 = ty.w0 * to_f32(a00.v[e]) + ty.w1 * to_f32(a10.v[e]);
      const float c1 = ty.w0 * to_f32(a01.v[e]) + ty.w1 * to_f32(a11.v[e]);
      out.v[e] = from_f32<T>(tx.w0 * c0 + tx.w1 * c1);
    }
    *reinterpret_cast<P*>(y + i * VEC) = out;
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, void* y, int batch, int h, int w, int c,
                   cudaStream_t stream) {
  constexpr int kThreads = 256;
  // (in - 1) / (out - 1) as _bilinear_matrix_align_corners takes it; 0 if in == 1
  const double scale_h = h > 1 ? static_cast<double>(h - 1) / (2 * h - 1) : 0.0;
  const double scale_w = w > 1 ? static_cast<double>(w - 1) / (2 * w - 1) : 0.0;
  const size_t total = static_cast<size_t>(batch) * (2 * h) * (2 * w) * (c / VEC);
  upsample_2x_kernel<T, VEC><<<grid_for(total, kThreads), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), batch, h, w, c, scale_h,
      scale_w);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spig

// x: (batch, h, w, c) contiguous; y: (batch, 2h, 2w, c) contiguous.
extern "C" int spig_upsample_2x(const void* x, void* y, int batch, int h,
                                int w, int c, int dtype, void* stream) {
  using namespace spig;
  if (batch < 1 || h < 1 || w < 1 || c < 1) return cudaErrorInvalidValue;
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
