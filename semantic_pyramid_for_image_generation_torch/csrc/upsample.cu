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
// down to H x W. Kernel 3 is a fixed 2x stencil and cannot run that. The
// backward is separable, gx = A_h^T g A_w, and each output row's two taps
// land on input rows i0 and i0 + 1, where i0 grows by at most one from one
// output row to the next. So a block streams output rows: it owns a strip of
// input rows (8, halved down to 1 until a launch has 1024 blocks, so small
// images still fill the card), 4 or 8 input columns and CP = 16 or 8 packs
// of VEC channels (64 threads, one per column and pack), and walks the
// output rows that touch the strip in order, through a ring of 4 rows in
// shared memory filled by 16-byte cp.async (3 rows in flight). For each
// output row a thread runs the W pass of its input column from shared
// memory into registers, then the H pass: it adds w_lo * t into input row
// i0 and w_hi * t into row i0 + 1, so only two rows of sums are live; a row
// is complete, rounded once and stored, when the output rows move past it.
// A warp ballot over the candidate rows and columns finds exactly the
// output rows and columns that touch the block before the first copy;
// while the first rows are in flight, the column tap weights are computed
// once per block (8 threads a column, a candidate each) and the row taps
// once per output row, with the forward's double-precision floor and clamp:
// exactly the non-zeros of the matrix builder's A^T, including the last
// output row whose clamp puts both taps on the last input row (i0 == i1,
// the two weights added into one) and in == 1 (weight 1 on both rows). No
// atomics: the sums run in a fixed order, so the result is deterministic.
//
// Bound: bytes. Kernel 3 needs ~6 flops per output and 4 reads that mostly
// hit in L1/L2; its unique traffic is the input once plus the output (4x the
// input) once. Kernel 3's design: one thread per (pixel, VEC consecutive
// channels); C is innermost, so a warp's loads and its store are coalesced
// 16-byte packs (float x4, bf16 x8); a grid-stride loop covers any shape.
// Kernel 5 reads g (4x its output) once from device memory, ~9 weighted adds
// per output element, and writes its output once; the halo columns and rows
// (about 3 beyond the 2 x 4 or 2 x 8 a block needs in each direction) are
// re-read by the neighbouring blocks from L2. In both, VEC = 1 takes channel
// counts that are not multiples of 4 / 8 (the narrow test widths).
//
// Numerics: the source coordinate i * (in - 1) / (out - 1) is taken in double
// with the same floor and clamp as ops/resize.py::
// _bilinear_matrix_align_corners (in == 1 gives weight 1 on row 0). The
// forward sums H pass first, then W pass, as the matrix form does; the
// backward takes the W pass first (its plain version the H pass). fp32
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

constexpr int kBackwardThreads = 64;
constexpr int kMaxStrip = 8;      // input rows per block, at most
constexpr int kRing = 4;          // output rows staged at once (3 in flight)
constexpr int kMaxTaps = 7;       // candidates per input row
constexpr int kMinBlocks = 1024;  // strips shrink until a launch has these

// The output columns whose taps touch input column j, ascending, each with
// j's share of it: row j of A_w^T without its zeros.
struct TapList {
  int n;
  int o[kMaxTaps];
  float w[kMaxTaps];
};

// An output row's two taps as the H pass adds them: w_lo into input row i0,
// w_hi into i0 + 1; where the clamp puts both taps on row i0, the matrix
// builder adds them into one weight.
struct RowTaps {
  int i0;
  float w_lo, w_hi;
};

// A block: `strip` input rows x kTileW input columns x CP packs of VEC
// channels, one thread per (column, pack).
template <typename T, int VEC, int CP>
struct BackwardRing {
  static_assert(8 * (kBackwardThreads / CP) <= kBackwardThreads,
                "8 threads for each column's candidates");
  static constexpr int kTileW = kBackwardThreads / CP;
  static constexpr int kCols = 2 * kTileW + 5;  // output columns it draws on
  static constexpr int kRows = 2 * kMaxStrip + 5;  // output rows it draws on
  TapList cols[kTileW];
  RowTaps rows[kRows];
  int range[4];  // first and last output row, first and last output column
  Pack<T, VEC> g[kRing][kCols * CP];
};

template <typename T, int VEC>
__device__ __forceinline__ void copy_pack(Pack<T, VEC>* dst, const T* src) {
  if constexpr (sizeof(Pack<T, VEC>) == 16) {
    cp_async16(dst, src);
  } else {
    *dst = *reinterpret_cast<const Pack<T, VEC>*>(src);
  }
}

template <typename T, int VEC, int CP>
__global__ void __launch_bounds__(kBackwardThreads)
    upsample_2x_backward_kernel(const T* __restrict__ g, T* __restrict__ gx,
                                int h, int w, int c, int strip, int strips,
                                int tiles_w, int chunks, double scale_h,
                                double scale_w) {
  using P = Pack<T, VEC>;
  using Ring = BackwardRing<T, VEC, CP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ring& ring = *reinterpret_cast<Ring*>(smem_raw);
  size_t blk = blockIdx.x;
  const int z = static_cast<int>(blk % chunks);
  blk /= chunks;
  const int x0 = static_cast<int>(blk % tiles_w) * Ring::kTileW;
  blk /= tiles_w;
  const int y0 = static_cast<int>(blk % strips) * strip;
  const size_t b = blk / strips;
  const int tw = min(Ring::kTileW, w - x0), y_end = min(y0 + strip, h);
  const int cv = c / VEC, wo = 2 * w, tid = threadIdx.x;
  const int x = tid / CP, pk = z * CP + tid % CP;
  const bool active = x < tw && pk < cv;

  // the output rows and columns that touch the block's input rows and
  // columns: warp 0 tests the candidates of the first and last input row
  // (lanes 0-7, 8-15) and column (16-23, 24-31), one each
  if (tid < 32) {
    const int side = tid >> 3, k = tid & 7;
    const bool col = side >= 2, last = side & 1;
    const int j = col ? (last ? x0 + tw - 1 : x0) : (last ? y_end - 1 : y0);
    const int in = col ? w : h;
    int lo, hi;
    candidates(j, in, &lo, &hi);
    const int o = last ? hi - k : lo + k;
    const bool hit = k <= hi - lo &&
                     share(o, j, in, col ? scale_w : scale_h).touches;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    const int nearest = __ffs((ballot >> (8 * side)) & 0xffu) - 1;
    if (k == 0) ring.range[side] = last ? hi - nearest : lo + nearest;
  }
  __syncthreads();
  const int oy_first = ring.range[0], ox0 = ring.range[2];
  const int rows = ring.range[1] - oy_first + 1;  // <= kRows
  const int nc = ring.range[3] - ox0 + 1;         // <= kCols

  // output row oy_first + r (its columns ox0.., this block's packs) into
  // ring slot r % kRing; one cp.async group per row, empty past the end
  const T* gb = g + ((b * 2 * h + oy_first) * wo + ox0) * c + z * CP * VEC;
  auto stage = [&](int r) {
    if (r < rows) {
      P* dst = ring.g[r % kRing];
      const T* src = gb + static_cast<size_t>(r) * wo * c;
      for (int i = tid; i < nc * CP; i += kBackwardThreads) {
        const int col = i / CP, q = i - col * CP;
        if (z * CP + q < cv) {
          copy_pack<T, VEC>(dst + i, src + static_cast<size_t>(col) * c +
                                         q * VEC);
        }
      }
    }
    cp_async_commit();
  };
  auto store = [&](int row, const float* a) {
    P out;
#pragma unroll
    for (int e = 0; e < VEC; ++e) out.v[e] = from_f32<T>(a[e]);
    *reinterpret_cast<P*>(gx + ((b * h + row) * w + x0 + x) * c + pk * VEC) =
        out;
  };
  for (int r = 0; r < kRing - 1; ++r) stage(r);

  // while the first rows are in flight: tap weights once per column of the
  // tile (8 threads a column, a candidate each, compacted by a ballot) and
  // once per output row
  {
    const int xc = tid >> 3, k = tid & 7;
    int lo = 0, hi = -1;
    if (xc < tw) candidates(x0 + xc, w, &lo, &hi);
    const Share sh = k <= hi - lo ? share(lo + k, x0 + xc, w, scale_w)
                                  : Share{false, 0.0f};
    const unsigned group =
        (__ballot_sync(0xffffffffu, sh.touches) >> (tid & 24)) & 0xffu;
    if (sh.touches) {
      const int pos = __popc(group & ((1u << k) - 1));
      ring.cols[xc].o[pos] = lo + k;
      ring.cols[xc].w[pos] = sh.weight;
    }
    if (xc < tw && k == 0) ring.cols[xc].n = __popc(group);
  }
  for (int r = tid; r < rows; r += kBackwardThreads) {
    const Taps t = taps(oy_first + r, h, scale_h);
    const bool clamped = t.i1 == t.i0;
    ring.rows[r] = {t.i0, clamped ? t.w0 + t.w1 : t.w0,
                    clamped ? 0.0f : t.w1};
  }
  const TapList& taps_x = ring.cols[min(x, tw - 1)];
  // input rows cur and cur + 1 collect the terms of the current output row;
  // a row is complete (and stored) once the output rows move past it
  float acc0[VEC], acc1[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc0[e] = acc1[e] = 0.0f;
  int cur = taps(oy_first, h, scale_h).i0;
  for (int r = 0; r < rows; ++r) {
    cp_async_wait<kRing - 2>();  // this thread's copies of row r landed
    __syncthreads();             // everyone's; row r - 1 is consumed
    stage(r + kRing - 1);        // into row r - 1's slot
    const RowTaps ty = ring.rows[r];
    if (ty.i0 > cur) {  // by one at most: scale < 1/2
      if (active && cur >= y0 && cur < y_end) store(cur, acc0);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        acc0[e] = acc1[e];
        acc1[e] = 0.0f;
      }
      ++cur;
    }
    if (!active) continue;
    // W pass of this output row at input column x
    const P* row = ring.g[r % kRing];
    float t[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) t[e] = 0.0f;
    for (int k = 0; k < taps_x.n; ++k) {
      const P gp = row[(taps_x.o[k] - ox0) * CP + tid % CP];
#pragma unroll
      for (int e = 0; e < VEC; ++e) t[e] += taps_x.w[k] * to_f32(gp.v[e]);
    }
    // H pass
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      acc0[e] += ty.w_lo * t[e];
      acc1[e] += ty.w_hi * t[e];
    }
  }
  if (active) {
    if (cur >= y0 && cur < y_end) store(cur, acc0);
    if (cur + 1 >= y0 && cur + 1 < y_end) store(cur + 1, acc1);
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

// CP packs a block: 8 where a pixel has at most 8 (16 columns a block), else
// 16 (8 columns); VEC = 1 takes 16 channels.
template <typename T, int VEC, int CP>
cudaError_t launch_backward(const void* g, void* gx, int batch, int h, int w,
                            int c, cudaStream_t stream) {
  using Ring = BackwardRing<T, VEC, CP>;
  static_assert(sizeof(Ring) <= 48 * 1024, "static shared memory limit");
  const int tiles_w = (w + Ring::kTileW - 1) / Ring::kTileW;
  const int chunks = (c / VEC + CP - 1) / CP;
  const size_t columns = static_cast<size_t>(batch) * tiles_w * chunks;
  // short strips for small images: more blocks, each walking fewer rows
  int strip = kMaxStrip;
  while (strip > 1 && columns * ((h + strip - 1) / strip) < kMinBlocks) {
    strip /= 2;
  }
  const int strips = (h + strip - 1) / strip;
  const size_t blocks = columns * strips;
  if (blocks > 0x7fffffffu) return cudaErrorInvalidValue;
  upsample_2x_backward_kernel<T, VEC, CP>
      <<<static_cast<unsigned>(blocks), kBackwardThreads, sizeof(Ring),
         stream>>>(static_cast<const T*>(g), static_cast<T*>(gx), h, w, c,
                   strip, strips, tiles_w, chunks, scale_2x(h), scale_2x(w));
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t dispatch_backward(const void* g, void* gx, int batch, int h, int w,
                              int c, cudaStream_t stream) {
  if constexpr (VEC > 1) {
    if (c / VEC <= 8) {
      return launch_backward<T, VEC, 8>(g, gx, batch, h, w, c, stream);
    }
  }
  return launch_backward<T, VEC, 16>(g, gx, batch, h, w, c, stream);
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
      return dispatch_backward<float, 4>(g, gx, batch, h, w, c, s);
    }
    return dispatch_backward<float, 1>(g, gx, batch, h, w, c, s);
  }
  if (dtype == kBFloat16) {
    if (packed && c % 8 == 0) {
      return dispatch_backward<__nv_bfloat16, 8>(g, gx, batch, h, w, c, s);
    }
    return dispatch_backward<__nv_bfloat16, 1>(g, gx, batch, h, w, c, s);
  }
  return cudaErrorInvalidValue;
}
