// Shared pieces of the paged-attention kernels: element conversion, the
// 16-byte vector load of one KV page tile, and the C error-string export.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tpuinf {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy one kv-head's [page_size, d] tile of a K and a V page into shared
// memory as float32, 16 bytes per thread per load (neighbouring threads
// on neighbouring addresses within a token row). `base` is the element
// offset of (page, token 0, head, 0); consecutive tokens are `row_stride`
// elements apart. K rows land `k_stride` floats apart (padding against
// bank conflicts where threads read different rows), V rows `d` apart.
// The launcher guarantees d % (16 / sizeof(T)) == 0 and 16-byte
// alignment of both pools.
template <typename T>
__device__ __forceinline__ void load_page_tile(
    const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    int64_t base, int64_t row_stride, int page_size, int d, int k_stride,
    float* k_s, float* v_s, int tid, int nthreads) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = d / kVec;
  for (int i = tid; i < page_size * nvec; i += nthreads) {
    const int t = i / nvec;
    const int c = (i - t * nvec) * kVec;
    const int64_t off = base + t * row_stride + c;
    const uint4 kraw = *reinterpret_cast<const uint4*>(k_pages + off);
    const uint4 vraw = *reinterpret_cast<const uint4*>(v_pages + off);
    const T* kx = reinterpret_cast<const T*>(&kraw);
    const T* vx = reinterpret_cast<const T*>(&vraw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      k_s[t * k_stride + c + j] = to_f32(kx[j]);
      v_s[t * d + c + j] = to_f32(vx[j]);
    }
  }
}

// Page id from the block table, bounds-checked: an id outside the pool
// is clamped into it, as the reference's gather clamps, instead of
// reading outside the allocation.
__device__ __forceinline__ int checked_page(const int* __restrict__ bt,
                                            int64_t idx, int num_pages) {
  return min(max(bt[idx], 0), num_pages - 1);
}

template <typename Kernel>
inline cudaError_t prepare_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace tpuinf

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
