// Kernel 3: 2x bilinear upsample with align_corners=True on NHWC memory,
// forward (nn.UpsamplingBilinear2d(scale_factor=2)), and Kernel 5, its
// backward.
//
// Kernel 3 replaces semantic_pyramid_for_image_generation_tpu/ops/pallas/
// resize.py::_forward (kernels _resize_kernel / _resize_kernel_small_c),
// reached through upsample_align_corners_pallas. The TPU kernel applied dense
// (out, in) interpolation matrices A_h x A_w^T on the MXU. A row of those
// matrices has at most two non-zeros, so on Hopper each output is a 2-tap
// stencil in each axis, and no matrix is formed.
//
// Kernel 3 is bound by bytes: it must read the input once and write the
// output (4x the input) once, and does ~3 flops per output element. A thread
// per output pack, as it first was, ran at half of that bound in bf16: the
// work per pack, not device memory, set its pace (64-bit index division, the
// taps in double twice, four input loads served from L1/L2, the H pass twice
// per output, a conversion instruction per bf16 element). So the work per
// pack is cut to the W pass and a share of the H pass:
//  - a block of 256 threads owns 2 * strip output rows, 2 * TW output columns
//    and CP packs of VEC channels (CP * TW = 128: CP = 8 where a pixel has at
//    most 8 packs, 32 for images at most 4 columns wide with 32 packs or
//    more, else 16), one thread per (output column, pack); strip is 8,
//    halved down to 1 until a launch has 1024 blocks, so small images still
//    fill the card;
//  - output rows 2j and 2j + 1 tap input rows j - 1 .. j + 1 (columns
//    likewise), so the block stages its strip and tile of the input with a
//    halo of at most one row and one column on each side, by 16-byte
//    cp.async: each input byte comes from device memory once per block;
//  - while the copies are in flight, the taps of the block's output rows
//    (into shared memory) and of each thread's output column (registers) are
//    computed once, with the matrix builder's double-precision floor and
//    clamp; the block's place comes from one 32-bit decomposition of
//    blockIdx.x, and no division runs per pack;
//  - for each pair of output rows, the H pass runs once per (output row,
//    staged column, pack) into a double-buffered fp32 tile in shared memory,
//    in planes of 4 channels so that a warp's 16-byte accesses are free of
//    bank conflicts; after one barrier the W pass reads two of its columns
//    per output pack, and the block stores whole output rows in coalesced
//    16-byte packs along C;
//  - bf16 becomes fp32 by bit shifts of each pair of values, and fp32 is
//    rounded back a pair per instruction: element-wise conversions cost the
//    bf16 kernel most of its gain.
// Tried and not kept: the 4-tap stencil straight from the staged input (no
// shared H pass; as fast), persistent blocks that prefetch their next strip
// (slower: fewer blocks fit an SM), and a streaming-store hint (faster alone
// at the middle sizes, where it keeps the input in L2 between repeated
// launches; no gain before the convolution that reads the output).
//
// Kernel 5 replaces ops/pallas/resize.py::_up_bwd, which ran the same
// _forward kernel with the transposed matrices, A_h^T g A_w, from 2H x 2W
// down to H x W. The backward is separable, gx = A_h^T g A_w, and each output
// row's two taps land on input rows i0 and i0 + 1, where i0 grows by at most
// one from one output row to the next. So a block streams output rows: it
// owns a strip of input rows (8, halved down to 1 until a launch has 1024
// blocks, so small images still fill the card), 4 or 8 input columns and CP
// = 16 or 8 packs of VEC channels (64 threads, one per column and pack), and
// walks the output rows that touch the strip in order, through a ring of 4
// rows in shared memory filled by 16-byte cp.async (3 rows in flight). For
// each output row a thread runs the W pass of its input column from shared
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
// Kernel 5 reads g (4x its output) once from device memory, ~9 weighted adds
// per output element, and writes its output once; the halo columns and rows
// (about 3 beyond the 2 x 4 or 2 x 8 a block needs in each direction) are
// re-read by the neighbouring blocks from L2.
//
// In both kernels VEC = 1 takes channel counts that are not multiples of 4 /
// 8 (the narrow test widths) and pointers not aligned to 16 bytes.
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

constexpr int kForwardThreads = 256;

// A tap pair as rows or columns of the block's staged input.
struct LocalTaps {
  int i0, i1;
  float w0, w1;
};

// Kernel 3's shared memory in front of the staged input: the taps of the
// block's output rows, and the H pass of one pair of output rows at every
// staged column, double-buffered, in fp32 planes of up to 4 channels.
template <typename T, int VEC, int CP>
struct ForwardTile {
  static constexpr int kTileW = kForwardThreads / (2 * CP);  // input columns
  static constexpr int kCols = kTileW + 2;  // staged: a halo on either side
  static constexpr int kVF = VEC < 4 ? VEC : 4;  // floats per plane
  static constexpr int kPlanes = VEC / kVF;
  using F = Pack<float, kVF>;
  static_assert(kCols <= 2 * kTileW, "one thread a staged column and pack");
  LocalTaps rows[2 * kMaxStrip];
  F t[2][2][kCols][kPlanes][CP];  // [buffer][row of the pair][column][plane][pack]
  // byte offset of the staged input, (strip + 2) x kCols x CP packs
  static constexpr size_t kInput = (sizeof(LocalTaps) * 2 * kMaxStrip +
                                    sizeof(F) * 4 * kCols * kPlanes * CP + 15) /
                                   16 * 16;
};

// A pack as fp32: bf16 pairs by bit shifts (exact).
template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Pack<T, VEC>& p, float* f) {
  if constexpr (sizeof(T) == 2 && VEC % 2 == 0) {
    const uint32_t* u = reinterpret_cast<const uint32_t*>(p.v);
#pragma unroll
    for (int e = 0; e < VEC / 2; ++e) {
      f[2 * e] = __uint_as_float(u[e] << 16);
      f[2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = to_f32(p.v[e]);
  }
}

// fp32 to a pack: bf16 rounds to nearest even, a pair per conversion.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> pack(const float* f) {
  Pack<T, VEC> p;
  if constexpr (sizeof(T) == 2 && VEC % 2 == 0) {
    __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(p.v);
#pragma unroll
    for (int e = 0; e < VEC / 2; ++e) {
      pairs[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) p.v[e] = from_f32<T>(f[e]);
  }
  return p;
}

template <typename T, int VEC, int CP>
__global__ void __launch_bounds__(kForwardThreads)
    upsample_2x_kernel(const T* __restrict__ x, T* __restrict__ y, int h,
                       int w, int c, int strip, int strips, int tiles_w,
                       int chunks, double scale_h, double scale_w) {
  using P = Pack<T, VEC>;
  using Tile = ForwardTile<T, VEC, CP>;
  using F = typename Tile::F;
  constexpr int kCols = Tile::kCols, kVF = Tile::kVF, kPlanes = Tile::kPlanes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tile& tile = *reinterpret_cast<Tile*>(smem_raw);
  P* in = reinterpret_cast<P*>(smem_raw + Tile::kInput);
  // the block's place, packs innermost, so that neighbours share halos in L2
  unsigned blk = blockIdx.x;
  const int z = static_cast<int>(blk % static_cast<unsigned>(chunks));
  blk /= static_cast<unsigned>(chunks);
  const int x0 = static_cast<int>(blk % static_cast<unsigned>(tiles_w)) *
                 Tile::kTileW;
  blk /= static_cast<unsigned>(tiles_w);
  const int y0 = static_cast<int>(blk % static_cast<unsigned>(strips)) * strip;
  const int b = static_cast<int>(blk / static_cast<unsigned>(strips));
  const int tid = threadIdx.x, k = tid / CP, q = tid % CP, pk = z * CP + q;
  const int cv = c / VEC;
  const int x_end = min(x0 + Tile::kTileW, w), y_end = min(y0 + strip, h);
  // the block's output rows 2 y0 .. 2 y_end - 1 tap input rows y0 - 1 ..
  // y_end, its columns likewise: stage those, thread (k, q) column k's pack
  // q of every row
  const int ry0 = max(y0 - 1, 0), nrows = min(y_end, h - 1) - ry0 + 1;
  const int rx0 = max(x0 - 1, 0), ncols = min(x_end, w - 1) - rx0 + 1;
  const bool h_pass = k < ncols && pk < cv;
  if (h_pass) {
    const size_t row = static_cast<size_t>(w) * c;
    const T* src = x + (static_cast<size_t>(b) * h + ry0) * row +
                   static_cast<size_t>(rx0 + k) * c + pk * VEC;
    for (int r = 0; r < nrows; ++r) {
      copy_pack<T, VEC>(in + (r * kCols + k) * CP + q, src + r * row);
    }
  }
  cp_async_commit();

  // while the copies are in flight: the taps of the block's output rows and
  // of this thread's output column, once
  const int steps = y_end - y0;  // pairs of output rows
  if (tid < 2 * steps) {
    const Taps t = taps(2 * y0 + tid, h, scale_h);
    tile.rows[tid] = {t.i0 - ry0, t.i1 - ry0, t.w0, t.w1};
  }
  const int ox = 2 * x0 + k;
  const bool stores = ox < 2 * w && pk < cv;
  const Taps tx = taps(min(ox, 2 * w - 1), w, scale_w);
  const int cx0 = tx.i0 - rx0, cx1 = tx.i1 - rx0;
  const size_t out_row = static_cast<size_t>(2 * w) * c;
  T* dst = y + (static_cast<size_t>(b) * 2 * h + 2 * y0) * out_row +
           static_cast<size_t>(ox) * c + pk * VEC;
  cp_async_wait<0>();
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    auto& t = tile.t[s & 1];  // H pass of output rows 2 s and 2 s + 1
    if (h_pass) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const LocalTaps ty = tile.rows[2 * s + r];
        float a[VEC], a1[VEC];
        unpack(in[(ty.i0 * kCols + k) * CP + q], a);
        unpack(in[(ty.i1 * kCols + k) * CP + q], a1);
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
          F v;
#pragma unroll
          for (int e = 0; e < kVF; ++e) {
            v.v[e] = ty.w0 * a[p * kVF + e] + ty.w1 * a1[p * kVF + e];
          }
          t[r][k][p][q] = v;
        }
      }
    }
    // the other buffer is written next; it was last read before this barrier
    __syncthreads();
    if (stores) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float o[VEC];
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
          const F c0 = t[r][cx0][p][q], c1 = t[r][cx1][p][q];
#pragma unroll
          for (int e = 0; e < kVF; ++e) {
            o[p * kVF + e] = tx.w0 * c0.v[e] + tx.w1 * c1.v[e];
          }
        }
        *reinterpret_cast<P*>(dst + (2 * s + r) * out_row) = pack<T, VEC>(o);
      }
    }
  }
}

template <typename T, int VEC, int CP>
cudaError_t launch_forward(const void* x, void* y, int batch, int h, int w,
                           int c, cudaStream_t stream) {
  using Tile = ForwardTile<T, VEC, CP>;
  static_assert(sizeof(Tile) <= Tile::kInput, "staged input after the tile");
  const int tiles_w = (w + Tile::kTileW - 1) / Tile::kTileW;
  const int chunks = (c / VEC + CP - 1) / CP;
  const size_t columns = static_cast<size_t>(batch) * tiles_w * chunks;
  int strip = kMaxStrip;
  while (strip > 1 && columns * ((h + strip - 1) / strip) < kMinBlocks) {
    strip /= 2;
  }
  const int strips = (h + strip - 1) / strip;
  const size_t blocks = columns * strips;
  if (blocks > 0x7fffffffu) return cudaErrorInvalidValue;
  const size_t smem = Tile::kInput + sizeof(Pack<T, VEC>) * (strip + 2) *
                                         Tile::kCols * CP;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        upsample_2x_kernel<T, VEC, CP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  upsample_2x_kernel<T, VEC, CP>
      <<<static_cast<unsigned>(blocks), kForwardThreads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<T*>(y), h, w, c, strip, strips,
          tiles_w, chunks, scale_2x(h), scale_2x(w));
  return cudaGetLastError();
}

// CP packs a block (TW = 128 / CP input columns): 8 where a pixel has at most
// 8; 32 for images at most 4 columns wide with 32 packs or more, so that the
// block's columns are not idle; else 16. VEC = 1 takes 16 channels.
template <typename T, int VEC>
cudaError_t dispatch_forward(const void* x, void* y, int batch, int h, int w,
                             int c, cudaStream_t stream) {
  if constexpr (VEC > 1) {
    if (c / VEC <= 8) {
      return launch_forward<T, VEC, 8>(x, y, batch, h, w, c, stream);
    }
    if (w <= 4 && c / VEC >= 32) {
      return launch_forward<T, VEC, 32>(x, y, batch, h, w, c, stream);
    }
  }
  return launch_forward<T, VEC, 16>(x, y, batch, h, w, c, stream);
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
    if (packed && c % 4 == 0) {
      return dispatch_forward<float, 4>(x, y, batch, h, w, c, s);
    }
    return dispatch_forward<float, 1>(x, y, batch, h, w, c, s);
  }
  if (dtype == kBFloat16) {
    if (packed && c % 8 == 0) {
      return dispatch_forward<__nv_bfloat16, 8>(x, y, batch, h, w, c, s);
    }
    return dispatch_forward<__nv_bfloat16, 1>(x, y, batch, h, w, c, s);
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
