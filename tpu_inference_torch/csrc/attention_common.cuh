// Shared pieces of the paged-attention kernels: element conversion, the
// 16-byte vector load (and dequantization) of one KV page tile, and the
// C error-string export.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// Pool kinds (the kv_kind argument of both launchers): a float pool in
// q's type, int8 codes, or packed int4 codes in uint8. A quantized pool
// carries one float32 scale per (page, token, head) beside its codes.
enum KvKind { kKvFloat = 0, kKvInt8 = 1, kKvInt4 = 2 };

// Sign-extended 4-bit codes of one packed byte, by compare and select
// as in the reference (engine/kv_cache.py unpack_int4_kv).
__device__ __forceinline__ int nibble_lo(uint8_t b) {
  const int x = b & 0xF;
  return x > 7 ? x - 16 : x;
}
__device__ __forceinline__ int nibble_hi(uint8_t b) {
  const int x = (b >> 4) & 0xF;
  return x > 7 ? x - 16 : x;
}

// Copy one kv-head's [page_size, d] tile of a K and a V page into shared
// memory as float32, 16 bytes per thread per load (neighbouring threads
// on neighbouring addresses within a token row). KV is the stored
// element type:
// - float or __nv_bfloat16: d values per row, converted;
// - int8_t: d codes per row, 16 per load, each times its row's scale;
// - uint8_t (packed int4): d / 2 bytes per row, 32 codes per load; byte
//   j's low nibble is column j and its high nibble column j + d / 2,
//   both sign-extended, then times the row's scale.
// Dequantization multiplies code by scale in float32, the same single
// rounding as the reference's codes.astype(f32) * scale. The scale of
// row (page, t, h) sits at (page * page_size + t) * hkv + h. K rows land
// `k_stride` floats apart (padding against bank conflicts where threads
// read different rows), V rows `d` apart. The launcher guarantees that
// a stored row is a multiple of 16 bytes and that both pools are 16-byte
// aligned.
template <typename KV>
__device__ __forceinline__ void load_page_tile(
    const KV* __restrict__ k_pages, const KV* __restrict__ v_pages,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    int page, int h, int hkv, int page_size, int d, int k_stride,
    float* k_s, float* v_s, int tid, int nthreads) {
  constexpr bool kPacked = std::is_same<KV, uint8_t>::value;
  constexpr bool kQuant = kPacked || std::is_same<KV, int8_t>::value;
  constexpr int kVec = 16 / sizeof(KV);     // stored elements per load
  const int d_pool = kPacked ? d / 2 : d;   // stored elements per row
  const int nvec = d_pool / kVec;
  for (int i = tid; i < page_size * nvec; i += nthreads) {
    const int t = i / nvec;
    const int c = (i - t * nvec) * kVec;
    const int64_t row = ((int64_t)page * page_size + t) * hkv + h;
    const int64_t off = row * d_pool + c;
    const uint4 kraw = *reinterpret_cast<const uint4*>(k_pages + off);
    const uint4 vraw = *reinterpret_cast<const uint4*>(v_pages + off);
    const KV* kx = reinterpret_cast<const KV*>(&kraw);
    const KV* vx = reinterpret_cast<const KV*>(&vraw);
    float* kr = k_s + t * k_stride;
    float* vr = v_s + t * d;
    if constexpr (kPacked) {
      const float ks = k_scale[row];
      const float vs = v_scale[row];
      const int half = d / 2;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        kr[c + j] = (float)nibble_lo(kx[j]) * ks;
        kr[c + j + half] = (float)nibble_hi(kx[j]) * ks;
        vr[c + j] = (float)nibble_lo(vx[j]) * vs;
        vr[c + j + half] = (float)nibble_hi(vx[j]) * vs;
      }
    } else if constexpr (kQuant) {
      const float ks = k_scale[row];
      const float vs = v_scale[row];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        kr[c + j] = (float)kx[j] * ks;
        vr[c + j] = (float)vx[j] * vs;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        kr[c + j] = to_f32(kx[j]);
        vr[c + j] = to_f32(vx[j]);
      }
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
