// Kernel 1: pooled-KV self-attention forward, out = softmax(q k^T) v per
// batch element, with fp32 logits and softmax.
//
// Replaces semantic_pyramid_for_image_generation_tpu/ops/pallas/attention.py::
// _forward (kernel _attention_kernel), reached through pooled_kv_attention.
// The TPU kernel held one batch element's whole (nq, nk) logit map in VMEM
// and ran both products on the MXU. Here no map is stored anywhere.
//
// Bound: at the generator's shape (q 1024x32, k 256x32, v 256x128 per
// element) the work is 2 * nq * nk * (c8 + c2) flops, ~100 per byte of q, k,
// v and out. Against the tensor cores' 989 TFLOP/s bf16 that is bound by
// bytes; in fp32, where parity forbids TF32 and the CUDA cores' 67 TFLOP/s
// is the peak, by operations. So the two dtypes get two designs.
//
// bf16 (attention_mma_kernel): both products on the tensor cores, as
// mma.sync m16n8k16 with bf16 operands and fp32 accumulators. A block of 8
// warps owns 64 queries of one batch element and up to 128 output channels
// (grid z splits wider c2): 4 groups of 16 queries (the mma's M), each
// served by 2 warps that take alternate 64-key tiles, so the serving shape
// runs 2048 warps, ~16 per SM. The block stages q and, where they fit in
// ~100 KB, the element's whole K and V in shared memory with cp.async
// (zero-filled to c8 a multiple of 16, c2 a multiple of 16 and nk a
// multiple of the key tile; rows padded to an odd number of 16-byte units,
// so ldmatrix is free of bank conflicts); otherwise it walks chunks of K and
// V. Fragments come from ldmatrix (ldmatrix.trans for V). The JAX kernel
// rounds the normalized p to bf16 before p @ v, so the kernel takes two
// passes over the keys: the first for each row's max and sum (online, on the
// accumulator fragments, quad shuffles; the two warps of a group then join
// theirs through shared memory), the second recomputes the logits
// (c8 / (c8 + c2) of the flops, 20% at the main shape), normalizes, rounds p
// to bf16 where JAX does and reuses the logit fragments, re-packed, as the A
// operand of p @ v. The second warp of a group hands its partial output to
// the first through shared memory, which adds it and stores. With so few
// flops the kernel is bound by the latency of each warp's chain of mma,
// exp and shuffle steps, not by a peak rate: exp is ex2.approx (__expf) and
// the division a multiply by 1 / l.
//
// fp32 (attention_fp32_kernel): full fp32 FMAs on the CUDA cores, register
// tiled. 256 threads own 64 queries and 64 * NCV output channels; each
// thread computes a 4 x 4 tile of the logits (q from shared memory as
// float4, 4 keys 16 apart so the reads are conflict-free) and a 4 x 4 * NCV
// tile of the output, for the same 4 query rows, so it holds their running
// max and sum itself. Keys are walked in tiles of 64 with an online softmax;
// probabilities pass to the p @ v loop through shared memory, where one
// float4 of p and NCV float4s of v feed 16 * NCV FMAs.
//
// No atomics anywhere: every output is written once, in a fixed order.
#include <math.h>

#include "common.cuh"

namespace spig {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kKeyTile = 64;    // keys per step, both kernels
constexpr int kQueryTile = 64;  // queries per block, both kernels

// ------------------------------------------------------------- bf16 / mma --

constexpr int kMmaWarps = 8;  // 4 groups of 16 queries x 2 halves of the keys
constexpr int kChunk = 128;                     // output channels per block
constexpr size_t kResidentBytes = 100 * 1024;   // 2 blocks per SM
constexpr int kStatsFloats = 2 * 2 * kQueryTile;  // (m, l) per half and row

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Row stride, in bf16 elements, for rows of `cols` (a multiple of 16): an odd
// number of 16-byte units, so 8 consecutive rows hit 8 distinct bank groups.
__host__ __device__ inline int padded_stride(int cols) {
  return ((cols / 8) | 1) * 8;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a b: a 16x16 (row), b 16x8 (col), bf16; c 16x8 fp32.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Stage rows x padded_cols of a row-major matrix (row length row_len,
// starting at column col0) into shared memory with row stride ds: element
// (r, c) is src[r * row_len + col0 + c] for r < valid_rows and c < cols, 0
// elsewhere. vec: 16-byte cp.async (row_len, col0 and cols multiples of 8,
// src 16-byte aligned); else element by element.
__device__ __forceinline__ void stage(bf16* dst, int ds, const bf16* src,
                                      int row_len, int rows, int valid_rows,
                                      int col0, int cols, int padded_cols,
                                      bool vec) {
  if (vec) {
    const int chunks = padded_cols / 8;
    for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
      const int r = i / chunks, c = (i - r * chunks) * 8;
      const bool ok = r < valid_rows && c < cols;
      cp_async16(dst + r * ds + c,
                 ok ? src + static_cast<size_t>(r) * row_len + col0 + c : src,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * padded_cols; i += blockDim.x) {
      const int r = i / padded_cols, c = i - r * padded_cols;
      dst[r * ds + c] =
          r < valid_rows && c < cols
              ? src[static_cast<size_t>(r) * row_len + col0 + c]
              : __float2bfloat16(0.f);
    }
  }
}

// The logits of this warp's 16 queries against 64 staged keys (k_w points at
// the tile's first key row), keys at or past nk_left masked to -inf.
// Fragment layout of s[n] (m16n8, g = lane / 4, t = lane % 4): s[n][0..1]
// row g, keys 8n + 2t + {0, 1}; s[n][2..3] row g + 8, the same keys.
template <int NK>
__device__ __forceinline__ void tile_logits(float s[8][4],
                                            const uint32_t qf[NK][4],
                                            const bf16* k_w, int ks, int nks,
                                            int nk_left, int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  const bf16* k_lane =
      k_w + ((lane & 7) + (lane >> 4) * 8) * ks + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int st = 0; st < NK; ++st) {
    if (st >= nks) break;
#pragma unroll
    for (int np = 0; np < 4; ++np) {  // 16 keys: two n-tiles
      uint32_t kf[4];
      ldmatrix_x4(kf, k_lane + np * 16 * ks + st * 16);
      mma_bf16(s[2 * np], qf[st], kf[0], kf[1]);
      mma_bf16(s[2 * np + 1], qf[st], kf[2], kf[3]);
    }
  }
  const int key = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (8 * n + key + (e & 1) >= nk_left) s[n][e] = -INFINITY;
    }
  }
}

// NK: capacity in 16-channel steps of q k^T (c8 <= 16 * NK); NO: capacity in
// 8-channel tiles of the output chunk (even; min(c2, 128) <= 8 * NO).
template <int NK, int NO>
__global__ void __launch_bounds__(kMmaWarps * 32, 2)
    attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         int nq, int nk, int c8, int c2, int resident,
                         bool vec_qk, bool vec_v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c8p = round_up(c8, 16), nks = c8p / 16;
  const int col0 = blockIdx.z * kChunk;
  const int cols = min(c2 - col0, kChunk);
  const int cw = round_up(cols, 16), nos = cw / 8;
  const int ks = padded_stride(c8p), vs = padded_stride(cw);
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kQueryTile][ks]
  float* stats_s = reinterpret_cast<float*>(q_s + kQueryTile * ks);
  bf16* k_s = reinterpret_cast<bf16*>(stats_s + kStatsFloats);  // [resident][ks]
  bf16* v_s = k_s + resident * ks;                // [resident][vs]
  float* o_s = reinterpret_cast<float*>(k_s);     // after pass 2: [64][cw + 8]

  const size_t b = blockIdx.y;
  const int q0 = blockIdx.x * kQueryTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // warp = (kh, wq): queries 16 wq.., the key tiles kh, kh + 2, ...
  const int wq = warp & 3, kh = warp >> 2;
  const bf16* kb = k + b * nk * c8;
  const bf16* vb = v + b * nk * c2;
  const bool one_chunk = resident >= nk;  // K and V staged once for both passes

  stage(q_s, ks, q + (b * nq + q0) * c8, c8, kQueryTile, nq - q0, 0, c8, c8p,
        vec_qk);
  stage(k_s, ks, kb, c8, resident, nk, 0, c8, c8p, vec_qk);
  cp_async_commit();
  if (one_chunk) stage(v_s, vs, vb, c2, resident, nk, col0, cols, cw, vec_v);
  cp_async_commit();  // V arrives while pass 1 runs
  cp_async_wait<1>();
  __syncthreads();

  // this warp's 16 query rows as A fragments, kept in registers
  uint32_t qf[NK][4];
  const bf16* q_lane = q_s + (wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 ks + (lane >> 4) * 8;
#pragma unroll
  for (int st = 0; st < NK; ++st) {
    qf[st][0] = qf[st][1] = qf[st][2] = qf[st][3] = 0u;
    if (st < nks) ldmatrix_x4(qf[st], q_lane + st * 16);
  }

  // pass 1: row max and sum over this warp's key tiles; [h] is row g (h = 0)
  // or g + 8 (h = 1)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[8][4];
  for (int k0 = 0; k0 < nk; k0 += resident) {
    if (k0 > 0) {
      __syncthreads();
      stage(k_s, ks, kb + static_cast<size_t>(k0) * c8, c8, resident, nk - k0,
            0, c8, c8p, vec_qk);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    for (int kt = kh * kKeyTile; kt < resident && k0 + kt < nk;
         kt += 2 * kKeyTile) {
      tile_logits<NK>(s, qf, k_s + kt * ks, ks, nks, nk - k0 - kt, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);  // finite: key kt is real
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          sum += __expf(s[n][2 * h] - m_new) + __expf(s[n][2 * h + 1] - m_new);
        }
        l[h] = l[h] * __expf(m[h] - m_new) + sum;
        m[h] = m_new;
      }
    }
  }
  // join the two halves' statistics, half 0 first in both warps: (m, 1 / l)
  // over all keys
  const int g = lane >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // each lane of a quad summed its own keys
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if ((lane & 3) == 0) {
      float* st = stats_s + 2 * (kh * kQueryTile + wq * 16 + g + 8 * h);
      st[0] = m[h];
      st[1] = l[h];
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* st0 = stats_s + 2 * (wq * 16 + g + 8 * h);
    const float* st1 = st0 + 2 * kQueryTile;
    m[h] = fmaxf(st0[0], st1[0]);  // finite: half 0 has key 0
    l[h] = 1.f / (st0[1] * __expf(st0[0] - m[h]) +
                  st1[1] * __expf(st1[0] - m[h]));
  }

  // pass 2 over this warp's key tiles: p = exp(s - m) / l, rounded to bf16 as
  // the JAX kernel rounds it, then o += p v on the tensor cores
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const int v_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * vs + (lane >> 4) * 8;
  for (int k0 = 0; k0 < nk; k0 += resident) {
    __syncthreads();
    if (!one_chunk) {
      stage(k_s, ks, kb + static_cast<size_t>(k0) * c8, c8, resident, nk - k0,
            0, c8, c8p, vec_qk);
      stage(v_s, vs, vb + static_cast<size_t>(k0) * c2, c2, resident, nk - k0,
            col0, cols, cw, vec_v);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int kt = kh * kKeyTile; kt < resident && k0 + kt < nk;
         kt += 2 * kKeyTile) {
      tile_logits<NK>(s, qf, k_s + kt * ks, ks, nks, nk - k0 - kt, lane);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 16 keys: one mma k-step
        uint32_t pa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* sn = s[2 * kk + half];
          pa[2 * half] = pack_bf16(__expf(sn[0] - m[0]) * l[0],
                                   __expf(sn[1] - m[0]) * l[0]);
          pa[2 * half + 1] = pack_bf16(__expf(sn[2] - m[1]) * l[1],
                                       __expf(sn[3] - m[1]) * l[1]);
        }
        const bf16* v_k = v_s + (kt + kk * 16) * vs + v_lane;
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          if (2 * np >= nos) break;
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, v_k + np * 16);
          mma_bf16(o[2 * np], pa, vf[0], vf[1]);
          mma_bf16(o[2 * np + 1], pa, vf[2], vf[3]);
        }
      }
    }
  }

  // o[n][0..1]: row g, channels 8n + 2t + {0, 1}; o[n][2..3]: row g + 8.
  // Half 1 hands its sums to half 0 through shared memory (over K and V,
  // which are consumed), which adds them to its own and stores.
  const int os = cw + 8;  // conflict-free float2 rows
  __syncthreads();
  if (kh == 1) {
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (n >= nos) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(
            o_s + (wq * 16 + g + 8 * h) * os + 8 * n + 2 * (lane & 3)) =
            make_float2(o[n][2 * h], o[n][2 * h + 1]);
      }
    }
  }
  __syncthreads();
  if (kh == 1) return;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (n >= nos) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 other = *reinterpret_cast<const float2*>(
          o_s + (wq * 16 + g + 8 * h) * os + 8 * n + 2 * (lane & 3));
      o[n][2 * h] += other.x;
      o[n][2 * h + 1] += other.y;
    }
  }
  const int row0 = q0 + wq * 16 + g;
  const bool pairs = (c2 & 1) == 0;  // 4-byte aligned channel pairs
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int ch = col0 + 8 * n + 2 * (lane & 3);
    if (8 * n >= cw || ch >= c2) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= nq) continue;
      bf16* dst = out + (b * nq + row) * c2 + ch;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(o[n][2 * h], o[n][2 * h + 1]);
      } else {
        dst[0] = __float2bfloat16(o[n][2 * h]);
        if (ch + 1 < c2) dst[1] = __float2bfloat16(o[n][2 * h + 1]);
      }
    }
  }
}

// Keys staged at once (a multiple of kKeyTile): all of them where q, K and V
// fit in kResidentBytes, else as many tiles as fit.
inline int resident_keys(int nk, int c8, int c2) {
  const int ks = padded_stride(round_up(c8, 16));
  const int vs = padded_stride(round_up(c2 < kChunk ? c2 : kChunk, 16));
  const size_t q_bytes = sizeof(bf16) * kQueryTile * ks +
                         sizeof(float) * kStatsFloats;
  const size_t per_key = sizeof(bf16) * (ks + vs);
  const int all = round_up(nk, kKeyTile);
  if (q_bytes + all * per_key <= kResidentBytes) return all;
  const int fit = static_cast<int>((kResidentBytes - q_bytes) / per_key);
  return fit / kKeyTile > 0 ? fit / kKeyTile * kKeyTile : kKeyTile;
}

template <int NK, int NO>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       int batch, int nq, int nk, int c8, int c2,
                       cudaStream_t stream) {
  const int resident = resident_keys(nk, c8, c2);
  const int ks = padded_stride(round_up(c8, 16));
  const int vs = padded_stride(round_up(c2 < kChunk ? c2 : kChunk, 16));
  const int cw = round_up(c2 < kChunk ? c2 : kChunk, 16);
  const size_t kv_bytes = sizeof(bf16) * resident * (ks + vs);
  const size_t o_bytes = sizeof(float) * kQueryTile * (cw + 8);
  const size_t smem = sizeof(bf16) * kQueryTile * ks +
                      sizeof(float) * kStatsFloats +
                      (kv_bytes > o_bytes ? kv_bytes : o_bytes);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_mma_kernel<NK, NO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const bool vec_qk = c8 % 8 == 0 && aligned_to(q, 16) && aligned_to(k, 16);
  const bool vec_v = c2 % 8 == 0 && aligned_to(v, 16);
  const dim3 grid((nq + kQueryTile - 1) / kQueryTile, batch,
                  (c2 + kChunk - 1) / kChunk);
  attention_mma_kernel<NK, NO><<<grid, kMmaWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), nq, nk, c8, c2,
      resident, vec_qk, vec_v);
  return cudaGetLastError();
}

template <int NK>
cudaError_t dispatch_mma_out(const void* q, const void* k, const void* v,
                             void* out, int batch, int nq, int nk, int c8,
                             int c2, cudaStream_t s) {
  const int nos = round_up(c2 < kChunk ? c2 : kChunk, 16) / 8;
  if (nos <= 4) return launch_mma<NK, 4>(q, k, v, out, batch, nq, nk, c8, c2, s);
  if (nos <= 8) return launch_mma<NK, 8>(q, k, v, out, batch, nq, nk, c8, c2, s);
  return launch_mma<NK, 16>(q, k, v, out, batch, nq, nk, c8, c2, s);
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v,
                         void* out, int batch, int nq, int nk, int c8, int c2,
                         cudaStream_t s) {
  const int nks = round_up(c8, 16) / 16;
  if (nks <= 2) return dispatch_mma_out<2>(q, k, v, out, batch, nq, nk, c8, c2, s);
  if (nks <= 4) return dispatch_mma_out<4>(q, k, v, out, batch, nq, nk, c8, c2, s);
  if (nks <= 8) return dispatch_mma_out<8>(q, k, v, out, batch, nq, nk, c8, c2, s);
  return dispatch_mma_out<16>(q, k, v, out, batch, nq, nk, c8, c2, s);
}

// ------------------------------------------------------------- fp32 / FMA --

constexpr int kF32Threads = 256;  // 16 x 16: ty owns 4 queries, tx 4 keys
constexpr int kQStride = kQueryTile + 4;  // q^T and p rows: float4-aligned
constexpr int kKStride = kKeyTile + 1;    // k^T rows: conflict-free stores

struct F32Layout {
  int q, k, v, p, total;  // offsets and size in floats
};

__host__ __device__ inline F32Layout f32_layout(int c8, int chunk) {
  F32Layout s;
  s.q = 0;                                           // [c8][kQStride]
  s.k = s.q + c8 * kQStride;                         // [c8][kKStride]
  s.v = round_up(s.k + c8 * kKStride, 4);            // [kKeyTile][chunk]
  s.p = s.v + kKeyTile * chunk;                      // [kKeyTile][kQStride]
  s.total = s.p + kKeyTile * kQStride;
  return s;
}

// NCV: float4 groups of output channels per thread; the block's chunk of c2
// is 64 * NCV channels (grid z splits wider c2).
template <int NCV>
__global__ void __launch_bounds__(kF32Threads)
    attention_fp32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out,
                          int nq, int nk, int c8, int c2, bool vec_v) {
  constexpr int kChunkF = 64 * NCV;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const F32Layout lay = f32_layout(c8, kChunkF);
  float* qt_s = smem + lay.q;
  float* kt_s = smem + lay.k;
  float* v_s = smem + lay.v;
  float* p_s = smem + lay.p;

  const size_t b = blockIdx.y;
  const int q0 = blockIdx.x * kQueryTile, col0 = blockIdx.z * kChunkF;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* qb = q + (b * nq + q0) * c8;
  const float* kb = k + b * nk * c8;
  const float* vb = v + b * nk * c2;

  for (int i = tid; i < kQueryTile * c8; i += kF32Threads) {
    const int r = i / c8, c = i - r * c8;
    qt_s[c * kQStride + r] = q0 + r < nq ? qb[i] : 0.f;
  }

  float m[4], l[4], acc[4][4 * NCV];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * NCV; ++e) acc[r][e] = 0.f;
  }

  for (int k0 = 0; k0 < nk; k0 += kKeyTile) {
    __syncthreads();  // the previous tile is consumed; q^T is staged
    const int keys = min(kKeyTile, nk - k0);
    for (int i = tid; i < kKeyTile * c8; i += kF32Threads) {
      const int r = i / c8, c = i - r * c8;
      kt_s[c * kKStride + r] =
          r < keys ? kb[static_cast<size_t>(k0) * c8 + i] : 0.f;
    }
    if (vec_v) {  // c2 % 4 == 0, v 16-byte aligned
      constexpr int kGroups = kChunkF / 4;
      for (int i = tid; i < kKeyTile * kGroups; i += kF32Threads) {
        const int r = i / kGroups, c = (i - r * kGroups) * 4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < keys && col0 + c < c2) {
          x = *reinterpret_cast<const float4*>(
              vb + static_cast<size_t>(k0 + r) * c2 + col0 + c);
        }
        *reinterpret_cast<float4*>(v_s + r * kChunkF + c) = x;
      }
    } else {
      for (int i = tid; i < kKeyTile * kChunkF; i += kF32Threads) {
        const int r = i / kChunkF, c = i - r * kChunkF;
        v_s[i] = r < keys && col0 + c < c2
                     ? vb[static_cast<size_t>(k0 + r) * c2 + col0 + c]
                     : 0.f;
      }
    }
    __syncthreads();

    // logits: rows 4 ty + r, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
    }
#pragma unroll 4
    for (int c = 0; c < c8; ++c) {
      const float4 qv = *reinterpret_cast<const float4*>(
          qt_s + c * kQStride + 4 * ty);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      const float* kr = kt_s + c * kKStride + tx;
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kr[16 * j];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = fmaf(qr[r], kv[j], s[r][j]);
      }
    }

    // online softmax over the 16 lanes that share ty
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (tx + 16 * j >= keys) s[r][j] = -INFINITY;
        mx = fmaxf(mx, s[r][j]);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      const float m_new = fmaxf(m[r], mx);  // finite: key k0 is real
      const float rescale = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= rescale;
#pragma unroll
      for (int e = 0; e < 4 * NCV; ++e) acc[r][e] *= rescale;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[r][j] = expf(s[r][j] - m_new);
        l[r] += s[r][j];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(p_s + (tx + 16 * j) * kQStride + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc += p v: rows 4 ty + r, channels 64 n + 4 tx + e
#pragma unroll 4
    for (int j = 0; j < keys; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(
          p_s + j * kQStride + 4 * ty);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int n = 0; n < NCV; ++n) {
        const float4 vv = *reinterpret_cast<const float4*>(
            v_s + j * kChunkF + 64 * n + 4 * tx);
        const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[r][4 * n + e] = fmaf(pr[r], vr[e], acc[r][4 * n + e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
    }
    const int row = q0 + 4 * ty + r;
    if (row >= nq) continue;
    float* dst = out + (b * nq + row) * c2;
#pragma unroll
    for (int n = 0; n < NCV; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = col0 + 64 * n + 4 * tx + e;
        if (ch < c2) dst[ch] = acc[r][4 * n + e] / l[r];
      }
    }
  }
}

template <int NCV>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* out,
                        int batch, int nq, int nk, int c8, int c2,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * f32_layout(c8, 64 * NCV).total;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fp32_kernel<NCV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const bool vec_v = c2 % 4 == 0 && aligned_to(v, 16);
  const dim3 grid((nq + kQueryTile - 1) / kQueryTile, batch,
                  (c2 + 64 * NCV - 1) / (64 * NCV));
  attention_fp32_kernel<NCV><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), nq, nk, c8, c2,
      vec_v);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spig

// q: (batch, nq, c8), k: (batch, nk, c8), v: (batch, nk, c2), out:
// (batch, nq, c2), all contiguous and of one dtype. c8 and c2 are at most
// 256; batch is at most 65535 (grid y).
extern "C" int spig_attention_forward(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int nq, int nk, int c8, int c2,
                                      int dtype, void* stream) {
  using namespace spig;
  if (batch < 1 || batch > 65535 || nq < 1 || nk < 1 || c8 < 1 || c8 > 256 ||
      c2 < 1 || c2 > 256) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    if (c2 <= 64) return launch_fp32<1>(q, k, v, out, batch, nq, nk, c8, c2, s);
    return launch_fp32<2>(q, k, v, out, batch, nq, nk, c8, c2, s);
  }
  if (dtype == kBFloat16) {
    return dispatch_mma(q, k, v, out, batch, nq, nk, c8, c2, s);
  }
  return cudaErrorInvalidValue;
}
