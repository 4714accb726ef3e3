// Kernel 3: 2x bilinear upsample with align_corners=True on NHWC memory,
// forward (nn.UpsamplingBilinear2d(scale_factor=2)), and Kernel 5, its
// backward.
//
// Kernel 3 replaces semantic_pyramid_for_image_generation_tpu/ops/pallas/
// resize.py::_forward (kernels _resize_kernel / _resize_kernel_small_c),
// reached through upsample_align_corners_pallas. The TPU kernel applied dense
// (out, in) interpolation matrices A_h x A_w^T on the MXU. A row of those
// matrices has at most two non-zeros, so on Hopper each output is a 2-tap
// stencil in each axis: four input reads and three weighted sums, no matrix.
//
// Kernel 5 replaces ops/pallas/resize.py::_up_bwd, which ran the same
// _forward kernel with the transposed matrices, A_h^T g A_w, from 2H x 2W
// down to H x W. Kernel 3 is a fixed 2x stencil and cannot run that, so the
// backward is a gather: one thread per (input pixel, VEC channels) visits the
// few output rows (at most 7 candidates, 2-4 touching) and columns whose taps
// touch it, recomputes each one's taps with the forward's floor and clamp,
// and sums w_row * w_col * g in fp32. Where the last output row clamps both
// taps onto the last input row (i0 == i1), the matrix builder adds both
// weights into one cell, and so does the gather. No atomics: the sum is
// deterministic, rounded once at the store.
//
// Bound: bytes. Kernel 3 needs ~6 flops per output and 4 reads that mostly
// hit in L1/L2; its unique traffic is the input once plus the output (4x the
// input) once. Kernel 5 reads g (4x its output) once through L1/L2 and writes
// its output once, ~9 weighted adds per element. Design of both: one thread
// per (pixel, VEC consecutive channels); C is innermost, so a warp's loads
// and its store are coalesced 16-byte packs (float x4, bf16 x8). A
// grid-stride loop covers any shape; VEC = 1 takes channel counts that are
// not multiples of 4 / 8 (the narrow test widths).
//
// Numerics: the source coordinate i * (in - 1) / (out - 1) is taken in double
// with the same floor and clamp as ops/resize.py::
// _bilinear_matrix_align_corners (in == 1 gives weight 1 on row 0). The
// forward sums H pass first, then W pass, as the matrix form does. fp32
// agrees with the matrix forms to fp32 rounding (not bitwise: FMA
// contraction, summation order and the zero terms of the dense products
// differ). bf16 is read into fp32 and rounded once at the store; the JAX
// bf16 forms round between their two passes.
#include "common.cuh"

namespace spig {
namespace {

// (in - 1) / (out - 1) for out = 2 * in, as _bilinear_matrix_align_corners
// takes it; 0 if in == 1
inline double scale_2x(int in) {
  return in > 1 ? static_cast<double>(in - 1) / (2 * in - 1) : 0.0;
}

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

// Input row j's share of output row o: the sum of o's tap weights that land
// on j (both of them where the clamp puts i0 == i1 == j). `touches` is false
// when neither tap lands on j.
struct Share {
  bool touches;
  float weight;
};

__device__ __forceinline__ Share share(int o, int j, int in, double scale) {
  const Taps t = taps(o, in, scale);
  Share s{false, 0.0f};
  if (t.i0 == j) {
    s.touches = true;
    s.weight += t.w0;
  }
  if (t.i1 == j) {
    s.touches = true;
    s.weight += t.w1;
  }
  return s;
}

// The output rows whose taps can touch input row j: o * scale < j - 1 for
// o < 2j - 2 and o * scale >= j + 1 for o > 2j + 4, since 1/scale =
// 2 + 1/(in - 1) lies in (2, 3] for in >= 2. in == 1: both output rows.
__device__ __forceinline__ void candidates(int j, int in, int* lo, int* hi) {
  if (in == 1) {
    *lo = 0;
    *hi = 1;
    return;
  }
  *lo = max(0, 2 * j - 2);
  *hi = min(2 * in - 1, 2 * j + 4);
}

template <typename T, int VEC>
__global__ void upsample_2x_backward_kernel(const T* __restrict__ g,
                                            T* __restrict__ gx, int batch,
                                            int h, int w, int c,
                                            double scale_h, double scale_w) {
  const int wo = 2 * w, cv = c / VEC;
  const size_t total = static_cast<size_t>(batch) * h * w * cv;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int ci = static_cast<int>(i % cv);
    size_t t = i / cv;
    const int ix = static_cast<int>(t % w);
    t /= w;
    const int iy = static_cast<int>(t % h);
    const size_t b = t / h;
    int ylo, yhi, xlo, xhi;
    candidates(iy, h, &ylo, &yhi);
    candidates(ix, w, &xlo, &xhi);
    const T* base = g + b * (2 * h) * wo * c + ci * VEC;
    using P = Pack<T, VEC>;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    for (int oy = ylo; oy <= yhi; ++oy) {
      const Share sy = share(oy, iy, h, scale_h);
      if (!sy.touches) continue;
      float row[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) row[e] = 0.0f;
      for (int ox = xlo; ox <= xhi; ++ox) {
        const Share sx = share(ox, ix, w, scale_w);
        if (!sx.touches) continue;
        const P gp = *reinterpret_cast<const P*>(
            base + (static_cast<size_t>(oy) * wo + ox) * c);
#pragma unroll
        for (int e = 0; e < VEC; ++e) row[e] += sx.weight * to_f32(gp.v[e]);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += sy.weight * row[e];
    }
    P out;
#pragma unroll
    for (int e = 0; e < VEC; ++e) out.v[e] = from_f32<T>(acc[e]);
    *reinterpret_cast<P*>(gx + i * VEC) = out;
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, void* y, int batch, int h, int w, int c,
                   cudaStream_t stream) {
  constexpr int kThreads = 256;
  const size_t total = static_cast<size_t>(batch) * (2 * h) * (2 * w) * (c / VEC);
  upsample_2x_kernel<T, VEC><<<grid_for(total, kThreads), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), batch, h, w, c,
      scale_2x(h), scale_2x(w));
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_backward(const void* g, void* gx, int batch, int h, int w,
                            int c, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const size_t total = static_cast<size_t>(batch) * h * w * (c / VEC);
  upsample_2x_backward_kernel<T, VEC>
      <<<grid_for(total, kThreads), kThreads, 0, stream>>>(
          static_cast<const T*>(g), static_cast<T*>(gx), batch, h, w, c,
          scale_2x(h), scale_2x(w));
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

// g: (batch, 2h, 2w, c) contiguous; gx: (batch, h, w, c) contiguous, every
// element written. h and w are the forward's input size.
extern "C" int spig_upsample_2x_backward(const void* g, void* gx, int batch,
                                         int h, int w, int c, int dtype,
                                         void* stream) {
  using namespace spig;
  if (batch < 1 || h < 1 || w < 1 || c < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const bool packed = aligned_to(g, 16) && aligned_to(gx, 16);
  if (dtype == kFloat32) {
    if (packed && c % 4 == 0) {
      return launch_backward<float, 4>(g, gx, batch, h, w, c, s);
    }
    return launch_backward<float, 1>(g, gx, batch, h, w, c, s);
  }
  if (dtype == kBFloat16) {
    if (packed && c % 8 == 0) {
      return launch_backward<__nv_bfloat16, 8>(g, gx, batch, h, w, c, s);
    }
    return launch_backward<__nv_bfloat16, 1>(g, gx, batch, h, w, c, s);
  }
  return cudaErrorInvalidValue;
}
