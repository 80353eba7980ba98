// Shared pieces of the paged-attention kernels: element conversion, the
// 16-byte vector load (and dequantization) of one KV page tile for the
// CUDA-core kernels, code-to-bf16 conversion for the tensor-core
// kernels, cp.async / ldmatrix / mma.sync wrappers, and the C
// error-string export.
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

// Two floats as one bf16x2 register, x in the low half (lower column).
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
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

// Codes to bf16 for the tensor cores, exact and without conversion
// instructions (which run at a quarter of the ALU rate). int8: a byte
// with its sign bit flipped is x + 128; as the low byte of the float
// 2^23 it gives 2^23 + x + 128, and subtracting 2^23 + 128 leaves x, a
// float whose low 16 bits are zero, so its high half is its bf16.
// Four codes (one word) -> two bf16x2 words.
__device__ __forceinline__ void s8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + k)) -
           8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}
// int4: a nibble n holds x = n, or n - 16 when n > 7, so n ^ 8 = x + 8;
// as the low mantissa bits of bf16 128.0 (0x4300) it gives 136 + x, and
// one bf16x2 subtraction of 136 leaves x. `u` holds four biased nibbles
// (n ^ 8), one per byte -> two bf16x2 words (bytes 0,1 and 2,3).
__device__ __forceinline__ void u4x4_to_bf16(uint32_t u, uint32_t& lo,
                                             uint32_t& hi) {
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
  uint32_t a = __byte_perm(u, 0x43434343u, 0x5140);
  uint32_t b = __byte_perm(u, 0x43434343u, 0x5342);
  __nv_bfloat162 x = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a), bias);
  __nv_bfloat162 y = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&b), bias);
  lo = *reinterpret_cast<uint32_t*>(&x);
  hi = *reinterpret_cast<uint32_t*>(&y);
}
// One 16-byte piece of a stored row as bf16 codes: int8 -> 16 values
// (lo[0..7], columns c..c+15); packed int4 -> the 16 low nibbles (lo,
// columns c..c+15) and the 16 high nibbles (hi, columns c+D/2..).
template <bool kPacked>
__device__ __forceinline__ void codes_to_bf16(const uint4& raw,
                                              uint32_t (&lo)[8],
                                              uint32_t (&hi)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (kPacked) {
      u4x4_to_bf16((w[k] & 0x0F0F0F0Fu) ^ 0x08080808u, lo[2 * k],
                   lo[2 * k + 1]);
      u4x4_to_bf16(((w[k] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, hi[2 * k],
                   hi[2 * k + 1]);
    } else {
      s8x4_to_bf16(w[k], lo[2 * k], lo[2 * k + 1]);
    }
  }
}

// The same piece times its row's scale, in float32, rounded once to bf16
// (the V rows: their scale cannot leave the sum over keys). The codes
// become floats by the same bias trick (int4: 2^23 + x + 8).
template <bool kPacked>
__device__ __forceinline__ void codes_to_bf16_scaled(const uint4& raw,
                                                     float sc,
                                                     uint32_t (&lo)[8],
                                                     uint32_t (&hi)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (kPacked) {
      const uint32_t a = (w[k] & 0x0F0F0F0Fu) ^ 0x08080808u;
      const uint32_t b = ((w[k] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
      float fa[4], fb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        fa[j] = (__uint_as_float(__byte_perm(a, 0x4B000000u, 0x7440 + j)) -
                 8388616.f) * sc;
        fb[j] = (__uint_as_float(__byte_perm(b, 0x4B000000u, 0x7440 + j)) -
                 8388616.f) * sc;
      }
      lo[2 * k] = pack_bf16(fa[0], fa[1]);
      lo[2 * k + 1] = pack_bf16(fa[2], fa[3]);
      hi[2 * k] = pack_bf16(fb[0], fb[1]);
      hi[2 * k + 1] = pack_bf16(fb[2], fb[3]);
    } else {
      const uint32_t u = w[k] ^ 0x80808080u;
      float f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[j] = (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + j)) -
                8388736.f) * sc;
      lo[2 * k] = pack_bf16(f[0], f[1]);
      lo[2 * k + 1] = pack_bf16(f[2], f[3]);
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

// Largest dynamic shared memory one block may ask for on sm_90.
constexpr size_t kMaxSmem = 232448;

template <typename Kernel>
inline cudaError_t prepare_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// ---- Asynchronous copies (cp.async): global -> shared without registers.
// With `valid` false nothing is read and the destination is zero-filled
// (src-size 0), so a slot past the last key holds finite zeros.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- Tensor-core fragments (mma.sync m16n8k16, bf16 in, f32 out).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tpuinf

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
