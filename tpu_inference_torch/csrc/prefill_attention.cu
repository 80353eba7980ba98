// Paged prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_inference/kernels/prefill_attention.py
// _prefill_kernel (launched by paged_prefill_attention): a chunk of S
// queries at absolute positions q_offset[b] + i attends over pool pages
// that hold the cached prefix plus the chunk's own KV (already written).
// One fused mask: causal (k_pos <= q_pos), k_pos < kv_len, and
// k_pos > q_pos - sliding_window when a window is set. Rows with no
// valid key output 0. Online softmax (m, l, acc) in float32. The pool
// holds q's type, or int8 codes, or packed int4 codes (uint8), the
// quantized kinds with per-(token, head) float32 scales, dequantized as
// each page tile enters shared memory (load_page_tile in
// attention_common.cuh), where the TPU kernel dequantizes in VMEM.
//
// What bounds it on this card: operations. A tile of query rows reuses
// every K/V page it loads across all its rows, so the work is
// 4 * Sq * Skv * Hq * D flops against O((Sq + Skv) * Hkv * D) bytes -
// hundreds of flops per byte at prefill lengths. This first version
// computes with scalar float32 FMAs from shared memory (no tensor cores),
// so it sits well under the bf16 tensor-core peak; wgmma with TMA-fed
// page tiles is later work.
//
// Design: one thread block per (query tile, kv-head, sequence); a tile
// is a fixed 64 (query position, GQA head) rows = 64 / n_rep query
// positions, with the ragged edge of the chunk masked. The block walks
// the pages from its window start (sliding window) or 0 up to
// min(kv_len, last query + 1); pages past kv_len or wholly in the causal
// future are never read. Each page's K/V tile is loaded once into shared
// memory (16-byte loads) and shared by all 64 rows: threads over
// (row, token) compute scores (K rows padded to D + 1 floats against
// bank conflicts), one thread per row folds the page into (m, l), and
// threads over (row, d) rescale acc. The reference's largest-divisor-
// of-S query block (a TPU tiling rule) is not carried over.

#include "attention_common.cuh"

namespace tpuinf {
namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;

template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const T* __restrict__ q,              // [B, S, Hq, D]
    const KV* __restrict__ k_pages,       // [P, pg, Hkv, D or D/2]
    const KV* __restrict__ v_pages,       // [P, pg, Hkv, D or D/2]
    const float* __restrict__ k_scale,    // [P, pg, Hkv] or null
    const float* __restrict__ v_scale,    // [P, pg, Hkv] or null
    const int* __restrict__ block_tables, // [B, MP]
    const int* __restrict__ kv_len,       // [B]
    const int* __restrict__ q_offset,     // [B]
    T* __restrict__ out,                  // [B, S, Hq, D]
    int s_len, int block_q, int num_pages, int page_size, int hkv, int n_rep,
    int d, int max_pages, int sliding_window, float scale) {
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int R = n_rep;
  const int rows = block_q * R;         // row = qi * R + r
  const int qs = d + 1;                 // padded row strides (bank conflicts)
  const int ks = d + 1;

  extern __shared__ float smem[];
  float* q_s = smem;                    // [rows, d + 1]
  float* acc = q_s + rows * qs;         // [rows, d]
  float* k_s = acc + rows * d;          // [pg, d + 1]
  float* v_s = k_s + page_size * ks;    // [pg, d]
  float* s_s = v_s + page_size * d;     // [rows, pg]  scores, then probs
  float* m_s = s_s + rows * page_size;  // [rows]
  float* l_s = m_s + rows;              // [rows]
  float* a_s = l_s + rows;              // [rows]

  const int hq = hkv * R;
  const int q0 = tile * block_q;        // first query index of the tile
  const int n_real = min(block_q, s_len - q0);
  for (int i = tid; i < rows * d; i += kThreads) {
    const int row = i / d;
    const int c = i - row * d;
    const int qi = row / R;
    const int r = row - qi * R;
    float x = 0.f;
    if (qi < n_real)
      x = to_f32(q[(((int64_t)b * s_len + q0 + qi) * hq + h * R + r) * d + c]);
    q_s[row * qs + c] = x;
    acc[i] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int len = kv_len[b];
  const int q_lo = q_offset[b] + q0;
  const int q_hi = q_lo + n_real - 1;   // last real query of the tile
  const int first =
      sliding_window > 0 ? max(q_lo - sliding_window + 1, 0) / page_size : 0;
  const int kv_end = min(len, q_hi + 1);  // keys at or past this are masked
  const int last = min((kv_end + page_size - 1) / page_size, max_pages);

  for (int p = first; p < last; ++p) {
    const int page =
        checked_page(block_tables, (int64_t)b * max_pages + p, num_pages);
    __syncthreads();  // the previous page's readers are done with the tiles
    load_page_tile(k_pages, v_pages, k_scale, v_scale, page, h, hkv,
                   page_size, d, ks, k_s, v_s, tid, kThreads);
    __syncthreads();
    const int page_start = p * page_size;
    for (int i = tid; i < rows * page_size; i += kThreads) {
      const int row = i / page_size;
      const int t = i - row * page_size;
      const int qi = row / R;
      const int q_pos = q_lo + qi;
      const int k_pos = page_start + t;
      bool valid = qi < n_real && k_pos <= q_pos && k_pos < len;
      if (sliding_window > 0) valid = valid && k_pos > q_pos - sliding_window;
      float dot = 0.f;
      if (valid) {
        const float* qr = q_s + row * qs;
        const float* kr = k_s + t * ks;
        for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
      }
      s_s[i] = valid ? dot * scale : kNegInf;
    }
    __syncthreads();
    for (int r = tid; r < rows; r += kThreads) {
      float* sr = s_s + r * page_size;
      float mx = kNegInf;
      for (int t = 0; t < page_size; ++t) mx = fmaxf(mx, sr[t]);
      const float m_new = fmaxf(m_s[r], mx);
      float sum = 0.f;
      for (int t = 0; t < page_size; ++t) {
        // Masked entries contribute nothing, even while the row's max
        // is still the mask value (rows with no valid key yet).
        const float e = sr[t] > 0.5f * kNegInf ? expf(sr[t] - m_new) : 0.f;
        sr[t] = e;
        sum += e;
      }
      const float alpha = expf(m_s[r] - m_new);
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < rows * d; i += kThreads) {
      const int row = i / d;
      const int c = i - row * d;
      const float* pr = s_s + row * page_size;
      float o = 0.f;
      for (int t = 0; t < page_size; ++t) o = fmaf(pr[t], v_s[t * d + c], o);
      acc[i] = acc[i] * a_s[row] + o;
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * d; i += kThreads) {
    const int row = i / d;
    const int c = i - row * d;
    const int qi = row / R;
    const int r = row - qi * R;
    if (qi < n_real)
      out[(((int64_t)b * s_len + q0 + qi) * hq + h * R + r) * d + c] =
          from_f32<T>(acc[i] / fmaxf(l_s[row], 1e-20f));
  }
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *bt, *kv_len, *q_offset;
  void* out;
  int batch, s_len, hq, hkv, d, num_pages, page_size, max_pages,
      sliding_window;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KV>
cudaError_t launch(const Args& a) {
  const int n_rep = a.hq / a.hkv;
  const int block_q = max(1, kTileRows / n_rep);
  const size_t rows = (size_t)block_q * n_rep;
  const size_t d = a.d, pg = a.page_size;
  const size_t smem = sizeof(float) * (rows * (d + 1) + rows * d +
                                       pg * (d + 1) + pg * d + rows * pg +
                                       3 * rows);
  cudaError_t err = prepare_smem(paged_prefill_kernel<T, KV>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.s_len + block_q - 1) / block_q, a.hkv, a.batch);
  paged_prefill_kernel<T, KV><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.kv_len), static_cast<const int*>(a.q_offset),
      static_cast<T*>(a.out), a.s_len, block_q, a.num_pages, a.page_size,
      a.hkv, n_rep, a.d, a.max_pages, a.sliding_window, a.scale);
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
extern "C" int paged_prefill_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* kv_len, const void* q_offset, void* out, int dtype,
    int kv_kind, int batch, int s_len, int hq, int hkv, int d,
    int num_pages, int page_size, int max_pages, int sliding_window,
    float scale, void* stream) {
  const tpuinf::Args a{q, k_pages, v_pages, k_scale, v_scale,
                       block_tables, kv_len, q_offset, out, batch, s_len,
                       hq, hkv, d, num_pages, page_size, max_pages,
                       sliding_window, scale,
                       static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return tpuinf::launch_kind<float>(kv_kind, a);
  if (dtype == 1) return tpuinf::launch_kind<__nv_bfloat16>(kv_kind, a);
  return cudaErrorInvalidValue;
}
