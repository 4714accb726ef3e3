// Helpers shared by the port's CUDA kernels: fp32 / bf16 element access,
// asynchronous copies into shared memory, and the dtype codes of the plain C
// interface (see ops/cuda/build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace spig {

// dtype codes passed from Python through ctypes
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// VEC consecutive elements loaded or stored as one aligned access
// (16 bytes for float x4 and bf16 x8).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously (cp.async, L2 only); the 16
// bytes are zero-filled, and src is not read, where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

inline bool aligned_to(const void* p, size_t bytes) {
  return reinterpret_cast<size_t>(p) % bytes == 0;
}

// Blocks for a grid-stride loop over `total` items with `threads` per block:
// enough to fill the card, capped so the index stays cheap.
inline unsigned grid_for(size_t total, int threads) {
  size_t blocks = (total + threads - 1) / threads;
  const size_t cap = 132 * 32;  // 32 blocks per SM on an H100's 132 SMs
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

}  // namespace spig
