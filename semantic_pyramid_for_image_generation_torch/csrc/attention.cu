// Kernel 1: pooled-KV self-attention forward, out = softmax(q k^T) v per
// batch element, with fp32 logits, softmax and accumulation.
//
// Replaces semantic_pyramid_for_image_generation_tpu/ops/pallas/attention.py::
// _forward (kernel _attention_kernel), reached through pooled_kv_attention.
// The TPU kernel held one batch element's whole (nq, nk) logit map in VMEM.
// Here no map is stored anywhere: a block owns 32 queries of one batch
// element and walks the keys in tiles of 32 with an online softmax (running
// max and sum per query), so shared memory stays small for any nk.
//
// Bound: at the generator's shape (q 1024x32, k 256x32, v 256x128 per
// element) the work is 2 * nq * nk * (c8 + c2) flops on ~0.8 MB (fp32) per
// element, ~100 flops per byte: operations bound in fp32, where parity
// forbids TF32 and the CUDA cores' 67 TFLOP/s is the peak; in bf16, against
// the tensor cores' peak, the same work is bound by bytes. This first version
// runs fp32 FMAs on the CUDA cores in both dtypes. Design: 8 warps x 4 queries a
// block. Lane j owns key j of the tile for the logits (K rows padded by one
// float so the 32 lanes hit 32 banks), and channels lane + 32 * i of the
// output; probabilities reach the other lanes by warp shuffles. K and V tiles
// are staged in shared memory as fp32 once per block and reused by all 32
// queries. wgmma / TMA are later work.
//
// Numerics: bf16 inputs are read into fp32; p stays fp32 for p @ v (the JAX
// kernel rounds p to bf16 first) and the output is rounded once.
#include <math.h>

#include "common.cuh"

namespace spig {
namespace {

constexpr int kWarps = 8;
constexpr int kQueriesPerWarp = 4;
constexpr int kQueryTile = kWarps * kQueriesPerWarp;
constexpr int kKeyTile = 32;  // one key per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

inline size_t smem_bytes(int c8, int c2) {
  return sizeof(float) *
         (static_cast<size_t>(kQueryTile) * c8 + kKeyTile * (c8 + 1) +
          kKeyTile * c2);
}

// NC = number of 32-channel output chunks a lane accumulates (c2 <= 32 * NC).
template <typename T, int NC>
__global__ void __launch_bounds__(kWarps * 32)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int nq,
                     int nk, int c8, int c2) {
  extern __shared__ float smem[];
  const int ks = c8 + 1;
  float* q_s = smem;                   // [kQueryTile][c8]
  float* k_s = q_s + kQueryTile * c8;  // [kKeyTile][c8 + 1]
  float* v_s = k_s + kKeyTile * ks;    // [kKeyTile][c2]

  const size_t b = blockIdx.y;
  const int q0 = blockIdx.x * kQueryTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* qb = q + b * nq * c8;
  const T* kb = k + b * nk * c8;
  const T* vb = v + b * nk * c2;

  for (int i = tid; i < kQueryTile * c8; i += blockDim.x) {
    const int qi = q0 + i / c8;
    q_s[i] = qi < nq ? to_f32(qb[static_cast<size_t>(q0) * c8 + i]) : 0.f;
  }

  float m[kQueriesPerWarp], l[kQueriesPerWarp], acc[kQueriesPerWarp][NC];
#pragma unroll
  for (int r = 0; r < kQueriesPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[r][n] = 0.f;
  }
  const float* q_w = q_s + warp * kQueriesPerWarp * c8;

  for (int kt = 0; kt < nk; kt += kKeyTile) {
    __syncthreads();  // the previous tile is consumed; q_s is ready
    for (int i = tid; i < kKeyTile * c8; i += blockDim.x) {
      const int r = i / c8, kj = kt + r;
      k_s[r * ks + (i - r * c8)] =
          kj < nk ? to_f32(kb[static_cast<size_t>(kt) * c8 + i]) : 0.f;
    }
    for (int i = tid; i < kKeyTile * c2; i += blockDim.x) {
      const int kj = kt + i / c2;
      v_s[i] = kj < nk ? to_f32(vb[static_cast<size_t>(kt) * c2 + i]) : 0.f;
    }
    __syncthreads();

    // logits of this lane's key for the warp's queries
    float s[kQueriesPerWarp];
#pragma unroll
    for (int r = 0; r < kQueriesPerWarp; ++r) s[r] = 0.f;
    const float* k_row = k_s + lane * ks;
    for (int ch = 0; ch < c8; ++ch) {
      const float kv = k_row[ch];
#pragma unroll
      for (int r = 0; r < kQueriesPerWarp; ++r) {
        s[r] = fmaf(q_w[r * c8 + ch], kv, s[r]);
      }
    }

    // online softmax: lane 0 of every tile holds a real key, so the tile max
    // is finite and exp(m_old - m_new) is 0 on the first tile
    const bool valid = kt + lane < nk;
    float p[kQueriesPerWarp];
#pragma unroll
    for (int r = 0; r < kQueriesPerWarp; ++r) {
      const float m_new = fmaxf(m[r], warp_max(valid ? s[r] : -INFINITY));
      const float rescale = expf(m[r] - m_new);
      p[r] = valid ? expf(s[r] - m_new) : 0.f;
      l[r] = l[r] * rescale + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[r][n] *= rescale;
    }

    const int keys = min(kKeyTile, nk - kt);
    for (int j = 0; j < keys; ++j) {
      float pj[kQueriesPerWarp];
#pragma unroll
      for (int r = 0; r < kQueriesPerWarp; ++r) {
        pj[r] = __shfl_sync(kFull, p[r], j);
      }
      const float* v_row = v_s + j * c2;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int ch = lane + 32 * n;
        const float vv = ch < c2 ? v_row[ch] : 0.f;
#pragma unroll
        for (int r = 0; r < kQueriesPerWarp; ++r) {
          acc[r][n] = fmaf(pj[r], vv, acc[r][n]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kQueriesPerWarp; ++r) {
    const int qi = q0 + warp * kQueriesPerWarp + r;
    if (qi >= nq) continue;
    const float inv = 1.f / l[r];
    T* o = out + (b * nq + qi) * c2;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int ch = lane + 32 * n;
      if (ch < c2) o[ch] = from_f32<T>(acc[r][n] * inv);
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int nq, int nk, int c8, int c2,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(c8, c2);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((nq + kQueryTile - 1) / kQueryTile, batch);
  attention_kernel<T, NC><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), nq, nk, c8, c2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int batch, int nq, int nk, int c8, int c2,
                     cudaStream_t s) {
  if (c2 <= 32) return launch<T, 1>(q, k, v, out, batch, nq, nk, c8, c2, s);
  if (c2 <= 64) return launch<T, 2>(q, k, v, out, batch, nq, nk, c8, c2, s);
  if (c2 <= 128) return launch<T, 4>(q, k, v, out, batch, nq, nk, c8, c2, s);
  return launch<T, 8>(q, k, v, out, batch, nq, nk, c8, c2, s);
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
    return dispatch<float>(q, k, v, out, batch, nq, nk, c8, c2, s);
  }
  if (dtype == kBFloat16) {
    return dispatch<__nv_bfloat16>(q, k, v, out, batch, nq, nk, c8, c2, s);
  }
  return cudaErrorInvalidValue;
}
