// Kernels 6-9: the generators' training-mode batch norms on bf16 NHWC
// activations, each fused with the activation that follows it.
//
// They replace no TPU kernel: the JAX package leaves its batch norms to XLA,
// which fuses the statistics, the normalization and the activation. The
// port's eager PyTorch made a dozen float32 passes over each input instead
// (a cast, two means, the affine into float32, a cast back, the activation;
// about 38 bytes an element forward), so these kernels take the place of
// that fusion:
//
//   6  statistics  the per-channel sum and sum of squares of x
//   7  apply       y = act(x * scale[s, c] + shift[s, c]) in one bf16 write
//   8  backward    per (segment, channel) sums of g' and g' * x, where
//      sums        g' = dy * act'(x * scale + shift)
//   9  backward    dx = g' * scale[s, c] + k[0, c] + k[1, c] * x
//      dx
//
// x is (rows of a segment) x C in NHWC memory, segment-major: a segment is
// one sample (the conditional norms' tables have a row per sample) or the
// whole batch (one row of tables). act is LeakyReLU with `slope` (ReLU at
// 0, none at 1). The tables are float32; all arithmetic is float32 in
// registers.
//
// All four are bound by device memory (2, 4, 4 and 6 bytes an element), so
// each reads 16-byte vectors of 8 channels, keeps a thread on one channel
// vector across the rows it walks (its tables stay in registers), and loads
// four rows ahead. The sums are deterministic: each block sums its rows in a
// fixed order and its threads in a fixed order; where a segment is split
// over several blocks, each writes its partial sums to a workspace and the
// last block of the segment to arrive (an integer ticket, no float atomics)
// adds the partials in split order.
#include "common.cuh"

namespace spig {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kUnroll = 4;  // rows loaded ahead by each thread
constexpr int kTickets = 1 << 14;
// blocks a launch aims for: two 512-thread blocks on each of 132 SMs for
// the sums, four for the elementwise passes
constexpr int kReduceBlocks = 2 * 132;
constexpr int kApplyBlocks = 4 * 132;

// Arrivals per (segment, channel slice) of a split reduction: zero when the
// library loads, and set back to zero by the block that finishes a group,
// so launches in stream order reuse them.
__device__ unsigned int g_tickets[kTickets];

struct Plan {
  int vec;          // channels a thread loads at once: 8 (16 bytes) or 1
  int tc, tr;       // threads along the channel vectors and along the rows
  int cslices;      // blocks along the channels
  int splits;       // blocks along a segment's rows
  long long rows_per_split;
};

Plan make_plan(long long rows, int segments, int channels, int target_blocks,
               bool vectors) {
  Plan p;
  p.vec = vectors ? 8 : 1;
  int vcols = channels / p.vec;
  p.tc = vcols < 32 ? vcols : 32;
  p.tr = kThreads / p.tc;
  p.cslices = (vcols + p.tc - 1) / p.tc;
  long long groups = static_cast<long long>(segments) * p.cslices;
  long long splits = (target_blocks + groups - 1) / groups;
  // at least 8 rows for each thread of a block
  long long most = (rows + 8LL * p.tr - 1) / (8LL * p.tr);
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  p.rows_per_split = (rows + splits - 1) / splits;
  p.splits =
      static_cast<int>((rows + p.rows_per_split - 1) / p.rows_per_split);
  if (p.splits < 1) p.splits = 1;
  return p;
}

template <int VEC>
__device__ __forceinline__ void load_row(const bf16* p, float (&v)[VEC]) {
  Pack<bf16, VEC> pk = *reinterpret_cast<const Pack<bf16, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = __bfloat162float(pk.v[i]);
}

template <int VEC>
__device__ __forceinline__ void store_row(bf16* p, const float (&v)[VEC]) {
  Pack<bf16, VEC> pk;
#pragma unroll
  for (int i = 0; i < VEC; ++i) pk.v[i] = __float2bfloat16(v[i]);
  *reinterpret_cast<Pack<bf16, VEC>*>(p) = pk;
}

template <int VEC>
__device__ __forceinline__ void load_table(const float* p, float (&v)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = p[i];
}

// g' = dy * act'(pre): the slope where pre <= 0, as torch's ReLU and
// LeakyReLU backward take it
__device__ __forceinline__ float act_grad(float dy, float pre, float slope) {
  return pre > 0.f ? dy : dy * slope;
}

__device__ __forceinline__ float act(float pre, float slope) {
  return pre > 0.f ? pre : pre * slope;
}

// The block's place: segment s, the rows [r0, r1) of its split, the thread's
// channel vector c0 (active: inside C and a full row of threads).
struct Place {
  int s;
  long long r0, r1, r;
  int c0;
  bool active;
};

__device__ __forceinline__ Place place(long long rows, int channels, int vec,
                                       int tc, int tr,
                                       long long rows_per_split) {
  Place q;
  q.s = blockIdx.y;
  const int lane_c = threadIdx.x % tc, lane_r = threadIdx.x / tc;
  q.c0 = (blockIdx.z * tc + lane_c) * vec;
  q.active = lane_r < tr && q.c0 < channels;
  q.r0 = blockIdx.x * rows_per_split;
  q.r1 = q.r0 + rows_per_split < rows ? q.r0 + rows_per_split : rows;
  q.r = q.r0 + lane_r;
  return q;
}

// The body of Kernels 6 and 8. out[(q * S + s) * C + c], q = 0: the sum
// of w, q = 1: the sum of w * x over segment s's rows, where w = x (GRAD
// false) or g'. partial: (S, splits, 2, C) floats where splits > 1.
template <int VEC, bool GRAD>
__device__ __forceinline__ void sums(
    const bf16* __restrict__ x, const bf16* __restrict__ dy,
    const float* __restrict__ scale, const float* __restrict__ shift,
    float slope, float* __restrict__ partial, float* __restrict__ out,
    long long rows, int channels, int tc, int tr, long long rows_per_split) {
  extern __shared__ float red[];  // [tr][2][tc * VEC], then the finish's
  __shared__ bool last;
  const int S = gridDim.y, splits = gridDim.x, width = tc * VEC;
  const Place p = place(rows, channels, VEC, tc, tr, rows_per_split);
  float a0[VEC], a1[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) a0[i] = a1[i] = 0.f;
  if (p.active) {
    float sc[VEC], sh[VEC];
    if (GRAD) {
      load_table<VEC>(scale + static_cast<size_t>(p.s) * channels + p.c0, sc);
      load_table<VEC>(shift + static_cast<size_t>(p.s) * channels + p.c0, sh);
    }
    const size_t base = static_cast<size_t>(p.s) * rows * channels + p.c0;
    long long r = p.r;
    for (; r + (kUnroll - 1) * tr < p.r1; r += kUnroll * tr) {
      float xv[kUnroll][VEC], gv[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t at = base + static_cast<size_t>(r + u * tr) * channels;
        load_row<VEC>(x + at, xv[u]);
        if (GRAD) load_row<VEC>(dy + at, gv[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float w = GRAD ? act_grad(gv[u][i],
                                          fmaf(xv[u][i], sc[i], sh[i]), slope)
                               : xv[u][i];
          a0[i] += w;
          a1[i] = fmaf(w, xv[u][i], a1[i]);
        }
      }
    }
    for (; r < p.r1; r += tr) {
      float xv[VEC], gv[VEC];
      const size_t at = base + static_cast<size_t>(r) * channels;
      load_row<VEC>(x + at, xv);
      if (GRAD) load_row<VEC>(dy + at, gv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float w = GRAD ? act_grad(gv[i], fmaf(xv[i], sc[i], sh[i]),
                                        slope)
                             : xv[i];
        a0[i] += w;
        a1[i] = fmaf(w, xv[i], a1[i]);
      }
    }
  }
  // the block's sum over its rows of threads, in row order
  const int lane_c = threadIdx.x % tc, lane_r = threadIdx.x / tc;
  if (lane_r < tr) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      red[(lane_r * 2 + 0) * width + lane_c * VEC + i] = a0[i];
      red[(lane_r * 2 + 1) * width + lane_c * VEC + i] = a1[i];
    }
  }
  __syncthreads();
  const int c_base = blockIdx.z * width;
  for (int o = threadIdx.x; o < 2 * width; o += blockDim.x) {
    const int q = o / width, j = o % width, c = c_base + j;
    float t = 0.f;
    for (int i = 0; i < tr; ++i) t += red[(i * 2 + q) * width + j];
    if (c < channels) {
      if (splits == 1)
        out[(static_cast<size_t>(q) * S + p.s) * channels + c] = t;
      else
        partial[((static_cast<size_t>(p.s) * splits + blockIdx.x) * 2 + q) *
                    channels + c] = t;
    }
  }
  if (splits == 1) return;
  // the last block of this (segment, channel slice) adds the partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int* ticket = &g_tickets[p.s * gridDim.z + blockIdx.z];
    last = atomicAdd(ticket, 1u) == static_cast<unsigned int>(splits - 1);
    if (last) *ticket = 0u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // `per` threads share an output: each adds a run of splits in order, then
  // the first adds the runs in order
  const int outputs = 2 * width;
  const int per = blockDim.x / outputs > 0 ? blockDim.x / outputs : 1;
  const int chunk = (splits + per - 1) / per;
  const int o = threadIdx.x / per, part = threadIdx.x % per;
  const bool works = threadIdx.x < per * outputs;
  __syncthreads();  // red is reused below
  for (int ob = 0; ob < outputs; ob += (blockDim.x / per)) {
    const int oo = ob + o;
    const int q = oo / width, j = oo % width, c = c_base + j;
    float t = 0.f;
    if (works && oo < outputs && c < channels) {
      const int from = part * chunk;
      const int to = from + chunk < splits ? from + chunk : splits;
      const float* src = partial + (static_cast<size_t>(p.s) * splits * 2 + q) *
                                       channels + c;
#pragma unroll 8
      for (int k = from; k < to; ++k)
        t += __ldcg(src + static_cast<size_t>(k) * 2 * channels);
    }
    if (works) red[threadIdx.x] = t;
    __syncthreads();
    if (works && part == 0 && oo < outputs && c < channels) {
      float total = 0.f;
      for (int k = 0; k < per; ++k) total += red[o * per + k];
      out[(static_cast<size_t>(q) * S + p.s) * channels + c] = total;
    }
    __syncthreads();
  }
}

// Kernel 6: the statistics. Kernels 6 and 8 are two kernels, not one
// template, so a device trace names each.
template <int VEC>
__global__ void __launch_bounds__(kThreads) batch_norm_stats_kernel(
    const bf16* __restrict__ x, float* __restrict__ partial,
    float* __restrict__ out, long long rows, int channels, int tc, int tr,
    long long rows_per_split) {
  sums<VEC, false>(x, nullptr, nullptr, nullptr, 0.f, partial, out, rows,
                   channels, tc, tr, rows_per_split);
}

// Kernel 8: the backward sums
template <int VEC>
__global__ void __launch_bounds__(kThreads) batch_norm_backward_sums_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dy,
    const float* __restrict__ scale, const float* __restrict__ shift,
    float slope, float* __restrict__ partial, float* __restrict__ out,
    long long rows, int channels, int tc, int tr, long long rows_per_split) {
  sums<VEC, true>(x, dy, scale, shift, slope, partial, out, rows, channels,
                  tc, tr, rows_per_split);
}

// Kernel 7
template <int VEC>
__global__ void __launch_bounds__(kThreads) batch_norm_apply_kernel(
    const bf16* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ shift, float slope, bf16* __restrict__ y,
    long long rows, int channels, int tc, int tr, long long rows_per_split) {
  const Place p = place(rows, channels, VEC, tc, tr, rows_per_split);
  if (!p.active) return;
  float sc[VEC], sh[VEC];
  load_table<VEC>(scale + static_cast<size_t>(p.s) * channels + p.c0, sc);
  load_table<VEC>(shift + static_cast<size_t>(p.s) * channels + p.c0, sh);
  const size_t base = static_cast<size_t>(p.s) * rows * channels + p.c0;
  long long r = p.r;
  for (; r + (kUnroll - 1) * tr < p.r1; r += kUnroll * tr) {
    float xv[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      load_row<VEC>(x + base + static_cast<size_t>(r + u * tr) * channels,
                    xv[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        xv[u][i] = act(fmaf(xv[u][i], sc[i], sh[i]), slope);
      store_row<VEC>(y + base + static_cast<size_t>(r + u * tr) * channels,
                     xv[u]);
    }
  }
  for (; r < p.r1; r += tr) {
    float xv[VEC];
    const size_t at = base + static_cast<size_t>(r) * channels;
    load_row<VEC>(x + at, xv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) xv[i] = act(fmaf(xv[i], sc[i], sh[i]), slope);
    store_row<VEC>(y + at, xv);
  }
}

// Kernel 9
template <int VEC>
__global__ void __launch_bounds__(kThreads) batch_norm_backward_dx_kernel(
    const bf16* __restrict__ dy, const bf16* __restrict__ x,
    const float* __restrict__ scale, const float* __restrict__ shift,
    const float* __restrict__ k, float slope, bf16* __restrict__ dx,
    long long rows, int channels, int tc, int tr, long long rows_per_split) {
  const Place p = place(rows, channels, VEC, tc, tr, rows_per_split);
  if (!p.active) return;
  float sc[VEC], sh[VEC], k0[VEC], k1[VEC];
  load_table<VEC>(scale + static_cast<size_t>(p.s) * channels + p.c0, sc);
  load_table<VEC>(shift + static_cast<size_t>(p.s) * channels + p.c0, sh);
  load_table<VEC>(k + p.c0, k0);
  load_table<VEC>(k + channels + p.c0, k1);
  const size_t base = static_cast<size_t>(p.s) * rows * channels + p.c0;
  long long r = p.r;
  for (; r + (kUnroll - 1) * tr < p.r1; r += kUnroll * tr) {
    float xv[kUnroll][VEC], gv[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t at = base + static_cast<size_t>(r + u * tr) * channels;
      load_row<VEC>(x + at, xv[u]);
      load_row<VEC>(dy + at, gv[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float g = act_grad(gv[u][i], fmaf(xv[u][i], sc[i], sh[i]),
                                 slope);
        xv[u][i] = fmaf(g, sc[i], fmaf(k1[i], xv[u][i], k0[i]));
      }
      store_row<VEC>(dx + base + static_cast<size_t>(r + u * tr) * channels,
                     xv[u]);
    }
  }
  for (; r < p.r1; r += tr) {
    float xv[VEC], gv[VEC];
    const size_t at = base + static_cast<size_t>(r) * channels;
    load_row<VEC>(x + at, xv);
    load_row<VEC>(dy + at, gv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float g = act_grad(gv[i], fmaf(xv[i], sc[i], sh[i]), slope);
      xv[i] = fmaf(g, sc[i], fmaf(k1[i], xv[i], k0[i]));
    }
    store_row<VEC>(dx + at, xv);
  }
}

bool vectors(int channels, const void* a, const void* b = nullptr) {
  return channels % 8 == 0 && aligned_to(a, 16) &&
         (b == nullptr || aligned_to(b, 16));
}

dim3 grid_of(const Plan& p, int segments) {
  return dim3(p.splits, segments, p.cslices);
}

}  // namespace
}  // namespace spig

using spig::bf16;

// Floats of workspace that spig_batch_norm_sums needs for x of `rows` rows a
// segment, `segments` segments and `channels` channels (0: none). The plan
// also depends on whether the pointers are 16-byte aligned, which this count
// does not know, so it covers both plans.
extern "C" long long spig_batch_norm_workspace(long long rows, int segments,
                                               int channels) {
  long long most = 0;
  for (bool vec : {true, false}) {
    if (vec && channels % 8) continue;
    spig::Plan p =
        spig::make_plan(rows, segments, channels, spig::kReduceBlocks, vec);
    long long need = p.splits > 1
        ? static_cast<long long>(segments) * p.splits * 2 * channels : 0;
    if (need > most) most = need;
  }
  return most;
}

// Kernels 6 (dy null: the statistics, out (2, C)) and 8 (out (2, S, C)).
extern "C" int spig_batch_norm_sums(const void* x, const void* dy,
                                    const float* scale, const float* shift,
                                    float slope, float* partial, float* out,
                                    long long rows, int segments, int channels,
                                    void* stream) {
  const bool grad = dy != nullptr;
  const bool vec = spig::vectors(channels, x, dy);
  spig::Plan p =
      spig::make_plan(rows, segments, channels, spig::kReduceBlocks, vec);
  if (static_cast<long long>(segments) * p.cslices > spig::kTickets)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(p.tr) * 2 * p.tc * p.vec *
                      sizeof(float);
  const dim3 grid = spig::grid_of(p, segments);
  const int threads = p.tc * p.tr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(dy);
#define SPIG_SUMS(V)                                                          \
  if (grad)                                                                   \
    spig::batch_norm_backward_sums_kernel<V><<<grid, threads, smem, s>>>(     \
        xb, gb, scale, shift, slope, partial, out, rows, channels, p.tc,      \
        p.tr, p.rows_per_split);                                              \
  else                                                                        \
    spig::batch_norm_stats_kernel<V><<<grid, threads, smem, s>>>(             \
        xb, partial, out, rows, channels, p.tc, p.tr, p.rows_per_split)
  if (vec) {
    SPIG_SUMS(8);
  } else {
    SPIG_SUMS(1);
  }
#undef SPIG_SUMS
  return static_cast<int>(cudaGetLastError());
}

// Kernel 7
extern "C" int spig_batch_norm_apply(const void* x, const float* scale,
                                     const float* shift, float slope, void* y,
                                     long long rows, int segments,
                                     int channels, void* stream) {
  const bool vec = spig::vectors(channels, x, y);
  spig::Plan p =
      spig::make_plan(rows, segments, channels, spig::kApplyBlocks, vec);
  const dim3 grid = spig::grid_of(p, segments);
  const int threads = p.tc * p.tr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* yb = static_cast<bf16*>(y);
  if (vec)
    spig::batch_norm_apply_kernel<8><<<grid, threads, 0, s>>>(
        xb, scale, shift, slope, yb, rows, channels, p.tc, p.tr,
        p.rows_per_split);
  else
    spig::batch_norm_apply_kernel<1><<<grid, threads, 0, s>>>(
        xb, scale, shift, slope, yb, rows, channels, p.tc, p.tr,
        p.rows_per_split);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 9
extern "C" int spig_batch_norm_backward_dx(const void* dy, const void* x,
                                           const float* scale,
                                           const float* shift, const float* k,
                                           float slope, void* dx,
                                           long long rows, int segments,
                                           int channels, void* stream) {
  const bool vec = spig::vectors(channels, x, dy) && spig::aligned_to(dx, 16);
  spig::Plan p =
      spig::make_plan(rows, segments, channels, spig::kApplyBlocks, vec);
  const dim3 grid = spig::grid_of(p, segments);
  const int threads = p.tc * p.tr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* gb = static_cast<const bf16*>(dy);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* db = static_cast<bf16*>(dx);
  if (vec)
    spig::batch_norm_backward_dx_kernel<8><<<grid, threads, 0, s>>>(
        gb, xb, scale, shift, k, slope, db, rows, channels, p.tc, p.tr,
        p.rows_per_split);
  else
    spig::batch_norm_backward_dx_kernel<1><<<grid, threads, 0, s>>>(
        gb, xb, scale, shift, k, slope, db, rows, channels, p.tc, p.tr,
        p.rows_per_split);
  return static_cast<int>(cudaGetLastError());
}
