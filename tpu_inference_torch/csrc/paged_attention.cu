// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_inference/kernels/paged_attention.py
// _decode_kernel (launched by paged_attention): one query token per
// sequence attends over its KV pages, followed through
// block_tables[b, p] (page 0 = trash page), with online softmax (m, l,
// acc) in float32, positions >= kv_len masked, GQA folded in (each KV
// head serves its n_rep query heads) and an optional sliding window.
// The pool holds q's type, or int8 codes, or packed int4 codes (uint8),
// the quantized kinds with per-(token, head) float32 scales; the TPU
// kernel's `quantized` and `packed` branches dequantize after each
// page's DMA, this one as each page tile enters shared memory
// (load_page_tile in attention_common.cuh).
//
// What bounds it on this card: bytes. Each sequence's K and V pages are
// read once per step and every element feeds 2 * n_rep flops, about 4
// flops per bf16 byte at n_rep 4, far under the ~295 the H100 needs
// before its tensor cores become the limit (3.35 TB/s HBM). int8 codes
// halve those bytes and int4 quarters them (plus 4 bytes of scale per
// token and head).
//
// Design: one thread block per (sequence, kv-head). The block reads its
// own block-table row and kv_len and walks the pages in a loop, which
// takes the place of the TPU's sequential page grid axis (Hopper blocks
// run in no order and carry nothing between them). Each page's [pg, D]
// K and V tile for this head is loaded once into shared memory with
// 16-byte loads and converted to float32; one warp per (row, token)
// computes a score with a shuffle reduction over D; one warp per query
// row folds the page into (m, l); threads over (row, d) rescale acc.
// The page walk starts at the window's first page under a sliding
// window, so it reads O(window) pages.
// Known limit: the grid is B * Hkv blocks (64 for Llama-3-8B at batch
// 8, on 132 SMs); a split-KV partition plus a reduce would fill the
// card at small batch and is later work.

#include "attention_common.cuh"

namespace tpuinf {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q,              // [B, Hq, D]
    const KV* __restrict__ k_pages,       // [P, pg, Hkv, D or D/2]
    const KV* __restrict__ v_pages,       // [P, pg, Hkv, D or D/2]
    const float* __restrict__ k_scale,    // [P, pg, Hkv] or null
    const float* __restrict__ v_scale,    // [P, pg, Hkv] or null
    const int* __restrict__ block_tables, // [B, MP]
    const int* __restrict__ kv_len,       // [B]
    T* __restrict__ out,                  // [B, Hq, D]
    int num_pages, int page_size, int hkv, int n_rep, int d, int max_pages,
    int sliding_window, float scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int R = n_rep;

  extern __shared__ float smem[];
  float* q_s = smem;                    // [R, d]
  float* acc = q_s + R * d;             // [R, d]
  float* k_s = acc + R * d;             // [pg, d]
  float* v_s = k_s + page_size * d;     // [pg, d]
  float* s_s = v_s + page_size * d;     // [R, pg]  scores, then probs
  float* m_s = s_s + R * page_size;     // [R]
  float* l_s = m_s + R;                 // [R]
  float* a_s = l_s + R;                 // [R]

  const int64_t q_base = ((int64_t)b * hkv * R + (int64_t)h * R) * d;
  for (int i = tid; i < R * d; i += kThreads) {
    q_s[i] = to_f32(q[q_base + i]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int len = kv_len[b];
  const int first =
      sliding_window > 0 ? max(len - sliding_window, 0) / page_size : 0;
  const int last = min((len + page_size - 1) / page_size, max_pages);

  for (int p = first; p < last; ++p) {
    const int page =
        checked_page(block_tables, (int64_t)b * max_pages + p, num_pages);
    __syncthreads();  // the previous page's readers are done with the tiles
    load_page_tile(k_pages, v_pages, k_scale, v_scale, page, h, hkv,
                   page_size, d, d, k_s, v_s, tid, kThreads);
    __syncthreads();
    const int page_start = p * page_size;
    for (int j = warp; j < R * page_size; j += kWarps) {
      const int r = j / page_size;
      const int t = j - r * page_size;
      const float* qr = q_s + r * d;
      const float* kr = k_s + t * d;
      float dot = 0.f;
      for (int c = lane; c < d; c += 32) dot = fmaf(qr[c], kr[c], dot);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) {
        const int pos = page_start + t;
        bool valid = pos < len;
        if (sliding_window > 0) valid = valid && pos >= len - sliding_window;
        s_s[j] = valid ? dot * scale : kNegInf;
      }
    }
    __syncthreads();
    for (int r = warp; r < R; r += kWarps) {
      float* sr = s_s + r * page_size;
      float mx = kNegInf;
      for (int t = lane; t < page_size; t += 32) mx = fmaxf(mx, sr[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page_size; t += 32) {
        // Masked entries contribute nothing, even while the row's max
        // is still the mask value.
        const float e = sr[t] > 0.5f * kNegInf ? expf(sr[t] - m_new) : 0.f;
        sr[t] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    for (int i = tid; i < R * d; i += kThreads) {
      const int r = i / d;
      const int c = i - r * d;
      const float* pr = s_s + r * page_size;
      float o = 0.f;
      for (int t = 0; t < page_size; ++t) o = fmaf(pr[t], v_s[t * d + c], o);
      acc[i] = acc[i] * a_s[r] + o;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * d; i += kThreads) {
    out[q_base + i] = from_f32<T>(acc[i] / fmaxf(l_s[i / d], 1e-20f));
  }
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *bt, *kv_len;
  void* out;
  int batch, hq, hkv, d, num_pages, page_size, max_pages, sliding_window;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KV>
cudaError_t launch(const Args& a) {
  const int n_rep = a.hq / a.hkv;
  const size_t r = n_rep, d = a.d, pg = a.page_size;
  const size_t smem = sizeof(float) * (2 * r * d + 2 * pg * d + r * pg + 3 * r);
  cudaError_t err = prepare_smem(paged_decode_kernel<T, KV>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.batch, a.hkv);
  paged_decode_kernel<T, KV><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.kv_len), static_cast<T*>(a.out),
      a.num_pages, a.page_size, a.hkv, n_rep, a.d, a.max_pages,
      a.sliding_window, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_kind(int kv_kind, const Args& a) {
  if (kv_kind == kKvFloat) return launch<T, T>(a);
  if ((a.k_scale == nullptr) || (a.v_scale == nullptr))
    return cudaErrorInvalidValue;
  if (kv_kind == kKvInt8) return launch<T, int8_t>(a);
  if (kv_kind == kKvInt4) return launch<T, uint8_t>(a);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace tpuinf

// dtype (of q and out): 0 = float32, 1 = bfloat16. kv_kind: 0 = pool in
// q's type (scales unused), 1 = int8 codes, 2 = packed int4 codes in
// uint8, both with float32 scales. Returns a cudaError_t (0 = launched).
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* kv_len, void* out, int dtype, int kv_kind, int batch,
    int hq, int hkv, int d, int num_pages, int page_size, int max_pages,
    int sliding_window, float scale, void* stream) {
  const tpuinf::Args a{q, k_pages, v_pages, k_scale, v_scale,
                       block_tables, kv_len, out, batch, hq, hkv, d,
                       num_pages, page_size, max_pages, sliding_window,
                       scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return tpuinf::launch_kind<float>(kv_kind, a);
  if (dtype == 1) return tpuinf::launch_kind<__nv_bfloat16>(kv_kind, a);
  return cudaErrorInvalidValue;
}
