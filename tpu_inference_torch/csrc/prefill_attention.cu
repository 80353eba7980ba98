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
// quantized kinds with per-(token, head) float32 scales.
//
// What bounds it on this card: operations. A tile of query rows reuses
// every K/V tile it loads across all its rows, so the work is
// 4 * Sq * Skv * Hq * D flops against O((Sq + Skv) * Hkv * D) bytes -
// hundreds of flops per byte at prefill lengths, above the ~295 per byte
// where the H100's bf16 tensor cores (989 TFLOP/s) and not its HBM
// (3.35 TB/s) are the limit.
//
// Design, bf16 q at head dims up to 256 (paged_prefill_kernel_mma): a
// flash-attention tile on the tensor cores. One block per (64-row tile,
// kv-head, sequence); a row is a (query position, GQA head) pair, so one
// K/V tile serves all n_rep heads of its kv-head. Each of the 4 warps
// owns 16 rows. Q sits in shared memory as bf16 (head dim padded to 64,
// 128 or 256 with zeros, rows padded by 16 bytes so ldmatrix is free of
// bank conflicts) and is loaded once. Each iteration takes 64 keys,
// every key row followed through the block table (page ids clamped into
// the pool) and copied with cp.async, 16 bytes per thread; the next
// tile's copies are in flight while the current one computes (two
// stages). S = Q.K^T and O += P.V are mma.sync.m16n8k16 bf16 -> f32,
// fed by ldmatrix (ldmatrix.trans for V). The online softmax stays in
// registers (FA2 style): each thread holds two rows' (m, l), the row
// max reduced over the quad that shares a row; P is rounded to bf16 in
// registers and becomes the A operand of P.V directly. Key tiles wholly
// past min(kv_len, last query + 1), or before the window's first key,
// are never loaded; the element mask runs only on tiles that cross a
// boundary.
//
// Quantized pools: the codes (and scales) of a tile land in a staging
// buffer through cp.async (two stages), then the warps convert them into
// the bf16 tile the tensor cores read, without conversion instructions
// (attention_common.cuh): K codes exactly, their scales kept beside the
// tile to multiply the float32 scores; V codes times their scale in
// float32, rounded once to bf16. That rounding is one the reference does
// not have (it multiplies dequantized float32 values); it stays inside
// the bf16 tolerance (2e-2 abs) the kernel is held to.
//
// float32 q, and bf16 q at head dims above 256 (paged_prefill_kernel):
// a CUDA-core kernel. TF32 would not hold float32 to its 1e-4 tolerance,
// and neither path is on the served models' main path. One block per
// (64-row tile, kv-head, sequence) walks the pages from the window start
// up to min(kv_len, last query + 1); each page's K/V tile is loaded into
// shared memory as float32 (load_page_tile), threads over (row, token)
// compute scores with scalar FMAs, one thread per row folds the page
// into (m, l), threads over (row, d) rescale acc.

#include "attention_common.cuh"

namespace tpuinf {
namespace {

// ------------------------------------------------------------------------
// Tensor-core kernel (bf16 q).

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kRows = 16 * kMmaWarps;  // M tile: (query, GQA head) rows
constexpr int kKeys = 64;              // N tile: keys per iteration

// Shared memory of the tensor-core kernel, in bytes. DP: padded head dim;
// row_bytes: stored bytes of one pool row (quantized pools only).
template <typename KV, int DP>
constexpr size_t mma_smem(int row_bytes) {
  constexpr bool kQuant = !std::is_same<KV, __nv_bfloat16>::value;
  constexpr size_t stride = DP + 8;  // bf16 elements per smem row
  const size_t q = kRows * stride * 2;
  if (!kQuant) return q + 2 * 2 * kKeys * stride * 2;
  return q + 2 * kKeys * stride * 2 + 2 * 2 * (size_t)kKeys * row_bytes +
         5 * kKeys * sizeof(float);
}

template <typename KV, int DP>
__global__ void __launch_bounds__(kMmaThreads) paged_prefill_kernel_mma(
    const __nv_bfloat16* __restrict__ q,  // [B, S, Hq, D]
    const KV* __restrict__ k_pages,       // [P, pg, Hkv, D or D/2]
    const KV* __restrict__ v_pages,       // [P, pg, Hkv, D or D/2]
    const float* __restrict__ k_scale,    // [P, pg, Hkv] or null
    const float* __restrict__ v_scale,    // [P, pg, Hkv] or null
    const int* __restrict__ block_tables, // [B, MP]
    const int* __restrict__ kv_len,       // [B]
    const int* __restrict__ q_offset,     // [B]
    __nv_bfloat16* __restrict__ out,      // [B, S, Hq, D]
    int s_len, int num_pages, int page_size, int hkv, int n_rep, int d,
    int max_pages, int sliding_window, float scale_log2) {
  constexpr bool kQuant = !std::is_same<KV, __nv_bfloat16>::value;
  constexpr bool kPacked = std::is_same<KV, uint8_t>::value;
  constexpr int S = DP + 8;        // smem row stride (bf16 elements)
  constexpr int kKB = DP / 16;     // k-blocks of S = Q.K^T
  constexpr int kDN = DP / 8;      // n-blocks of O
  constexpr bool kQRegs = DP <= 128;
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int R = n_rep;
  const int hq = hkv * R;
  const int row0 = tile * kRows;
  const int n_real = min(kRows, s_len * R - row0);
  // Stored bytes per pool row and 16-byte pieces per row.
  const int row_bytes = kPacked ? d / 2 : d * (int)sizeof(KV);
  const int cpr = row_bytes / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* tiles = q_s + kRows * S;  // float: [2][K,V][keys][S]
  // Quantized pools: one bf16 K/V tile, then [2][K,V][keys][row_bytes]
  // codes, [2][K,V][keys] scales and the tile's own [keys] K scales.
  unsigned char* codes =
      reinterpret_cast<unsigned char*>(tiles + 2 * kKeys * S);
  float* scales = reinterpret_cast<float*>(codes + 4 * kKeys * row_bytes);
  float* tile_scales = scales + 4 * kKeys;
  const int n_tile_bufs = kQuant ? 2 : 4;

  // Head-dim padding of the K/V tiles is zero for the whole run (copies
  // and dequantization write only columns < d).
  if (d < DP) {
    const int pad = DP - d;
    for (int i = tid; i < n_tile_bufs * kKeys * pad; i += kMmaThreads) {
      const int row = i / pad;
      tiles[row * S + d + (i - row * pad)] = __float2bfloat16(0.f);
    }
  }

  // Q tile: rows past the chunk and padding columns are zero.
  for (int i = tid; i < kRows * kDN; i += kMmaThreads) {
    const int row = i / kDN;
    const int c = (i - row * kDN) * 8;
    __nv_bfloat16* dst = q_s + row * S + c;
    if (row < n_real && c < d) {
      const int g = row0 + row;
      const int qi = g / R;
      const int r = g - qi * R;
      cp_async16(dst, q + (((int64_t)b * s_len + qi) * hq + h * R + r) * d + c,
                 true);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }

  const int len = min(kv_len[b], max_pages * page_size);
  const int qoff = q_offset[b];
  const int q_lo = qoff + row0 / R;                 // first real query
  const int q_hi = qoff + (row0 + n_real - 1) / R;  // last real query
  const int k_first = sliding_window > 0 ? max(q_lo - sliding_window + 1, 0)
                                         : 0;
  const int k_end = min(len, q_hi + 1);  // keys at or past this are masked
  const int n_tiles = k_end > k_first ? (k_end - k_first + kKeys - 1) / kKeys
                                      : 0;
  const int* bt = block_tables + (int64_t)b * max_pages;

  // Pool row ((page * pg + slot) * Hkv + h) of key warp * 16 + lane % 16
  // of tile `it`, or -1 past the keys. Read one tile ahead of its copies,
  // so the block-table read's latency hides behind compute.
  auto key_row = [&](int it) -> int64_t {
    const int pos = k_first + it * kKeys + warp * 16 + (lane & 15);
    if (it >= n_tiles || pos >= k_end) return -1;
    const int page = checked_page(bt, pos / page_size, num_pages);
    return ((int64_t)page * page_size + pos % page_size) * hkv + h;
  };

  // Issue the copies of key tile `it` into stage `st`: each warp copies
  // its 16 keys (`row` = key_row(it), passed to the copying lanes by a
  // shuffle).
  const unsigned char* k_bytes =
      reinterpret_cast<const unsigned char*>(k_pages);
  const unsigned char* v_bytes =
      reinterpret_cast<const unsigned char*>(v_pages);
  auto issue = [&](int it, int st, int64_t row) {
    if (it >= n_tiles) return;
    const int pieces = 16 * cpr;
    for (int k = 0; k < (pieces + 31) / 32; ++k) {
      const int p = lane + 32 * k;
      const int kl = min(p / cpr, 15);
      const int c = p - kl * cpr;
      const int64_t r = __shfl_sync(0xffffffffu, row, kl);
      if (p >= pieces) continue;
      const int key = warp * 16 + kl;
      const int64_t off = r < 0 ? 0 : r * row_bytes + c * 16;
      if constexpr (kQuant) {
        unsigned char* dk = codes + ((st * 2) * kKeys + key) * row_bytes;
        unsigned char* dv = dk + kKeys * row_bytes;
        cp_async16(dk + c * 16, k_bytes + off, r >= 0);
        cp_async16(dv + c * 16, v_bytes + off, r >= 0);
      } else {
        __nv_bfloat16* dk = tiles + ((st * 2) * kKeys + key) * S;
        __nv_bfloat16* dv = dk + kKeys * S;
        cp_async16(dk + c * 8, k_bytes + off, r >= 0);
        cp_async16(dv + c * 8, v_bytes + off, r >= 0);
      }
    }
    if constexpr (kQuant) {
      // Lanes 0..15 copy their keys' K scales, 16..31 the V scales.
      const int key = warp * 16 + (lane & 15);
      const bool is_v = lane >= 16;
      cp_async4(scales + (st * 2 + is_v) * kKeys + key,
                (is_v ? v_scale : k_scale) + (row < 0 ? 0 : row), row >= 0);
    }
  };

  // Convert stage `st`'s codes into the bf16 K/V tile: K codes exactly
  // (|code| <= 128), their scales kept beside the tile to multiply the
  // scores; V codes times their scale in float32, rounded once to bf16.
  auto dequant = [&](int st) {
    for (int i = tid; i < 2 * kKeys * cpr; i += kMmaThreads) {
      const int kv_row = i / cpr;  // 0..2*keys-1: K rows then V rows
      const int c = i - kv_row * cpr;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          codes + (st * 2 * kKeys + kv_row) * row_bytes + c * 16);
      __nv_bfloat16* dst = tiles + kv_row * S;
      uint32_t lo[8], hi[8];
      if (kv_row < kKeys)
        codes_to_bf16<kPacked>(raw, lo, hi);
      else
        codes_to_bf16_scaled<kPacked>(raw, scales[st * 2 * kKeys + kv_row],
                                      lo, hi);
      uint4* a = reinterpret_cast<uint4*>(dst + c * 16);
      a[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      a[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      if constexpr (kPacked) {
        uint4* z = reinterpret_cast<uint4*>(dst + c * 16 + d / 2);
        z[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        z[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
      }
    }
    if (tid < kKeys) tile_scales[tid] = scales[st * 2 * kKeys + tid];
  };

  // This thread's two rows (g and g + 8 of its warp's 16) and their
  // query positions.
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wrow = warp * 16;
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = qoff + (row0 + wrow + g + 8 * i) / R;

  float o[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share; quad-reduced at the end
  uint32_t qa[kQRegs ? kKB : 1][4];

  issue(0, 0, key_row(0));
  cp_async_commit();  // Q travels with tile 0
  issue(1, 1, key_row(1));
  cp_async_commit();
  int64_t ahead = key_row(2);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    cp_async_wait<1>();
    __syncthreads();  // tile `it` landed; every warp is done with it - 1
    if (it == 0 && kQRegs) {
#pragma unroll
      for (int kb = 0; kb < (kQRegs ? kKB : 1); ++kb)
        ldmatrix_x4(qa[kb], q_s + (wrow + (lane & 15)) * S + kb * 16 +
                                (lane >> 4) * 8);
    }
    const __nv_bfloat16* kt;
    if constexpr (kQuant) {
      dequant(st);
      __syncthreads();
      const int64_t row = ahead;  // the stage is free again
      ahead = key_row(it + 3);
      issue(it + 2, st, row);
      cp_async_commit();
      kt = tiles;
    } else {
      kt = tiles + st * 2 * kKeys * S;
    }
    const __nv_bfloat16* vt = kt + kKeys * S;
    const int k0 = k_first + it * kKeys;

    // S = Q.K^T for the warp's 16 rows x 64 keys.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kb = 0; kb < kKB; ++kb) {
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = qa[kQRegs ? kb : 0][j];
      } else {
        ldmatrix_x4(a, q_s + (wrow + (lane & 15)) * S + kb * 16 +
                           (lane >> 4) * 8);
      }
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        uint32_t bb[4];
        ldmatrix_x4(bb, kt + (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * S +
                            kb * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * nb], a, bb[0], bb[1]);
        mma_bf16(s[2 * nb + 1], a, bb[2], bb[3]);
      }
    }

    // Scale into the log2 domain; mask only tiles that cross a boundary
    // (kv_len, the causal diagonal of the block's first query, or the
    // window of its last).
    const bool full = k0 + kKeys <= k_end && k0 + kKeys - 1 <= q_lo &&
                      (sliding_window <= 0 || k0 > q_hi - sliding_window);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if constexpr (kQuant) x *= tile_scales[n * 8 + 2 * tq + (e & 1)];
        if (!full) {
          const int key = k0 + n * 8 + 2 * tq + (e & 1);
          const int qp = qpos[e >> 1];
          bool valid = key < len && key <= qp;
          if (sliding_window > 0) valid = valid && key > qp - sliding_window;
          x = valid ? x : kNegInf;
        }
        s[n][e] = x;
      }
    }

    // Online softmax, two rows per thread.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          // Masked entries contribute nothing, even while the row's max
          // is still the mask value.
          const float p = s[n][e] > 0.5f * kNegInf ? exp2f(s[n][e] - m_new)
                                                   : 0.f;
          s[n][e] = p;
          sum += p;
        }
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int n = 0; n < kDN; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }

    // O += P.V: P (bf16, from registers) is the A operand.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                        pack_bf16(s[2 * j][2], s[2 * j][3]),
                        pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                        pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DP / 16; ++dn) {
        uint32_t bb[4];
        ldmatrix_x4_trans(
            bb, vt + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S +
                    dn * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dn], pa, bb[0], bb[1]);
        mma_bf16(o[2 * dn + 1], pa, bb[2], bb[3]);
      }
    }

    if constexpr (!kQuant) {
      __syncthreads();  // every warp is done with stage st
      const int64_t row = ahead;
      ahead = key_row(it + 3);
      issue(it + 2, st, row);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float inv = li > 0.f ? 1.f / li : 0.f;  // no valid key: 0
    const int row = wrow + g + 8 * i;
    if (row >= n_real) continue;
    const int gr = row0 + row;
    const int qi = gr / R;
    const int r = gr - qi * R;
    __nv_bfloat16* dst =
        out + (((int64_t)b * s_len + qi) * hq + h * R + r) * d;
#pragma unroll
    for (int n = 0; n < kDN; ++n) {
      const int col = n * 8 + 2 * tq;
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
  }
}

// ------------------------------------------------------------------------
// CUDA-core kernel (float32 q; bf16 q above head dim 256).

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
cudaError_t launch_scalar(const Args& a) {
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

template <typename KV, int DP>
cudaError_t launch_mma_dp(const Args& a) {
  const int n_rep = a.hq / a.hkv;
  const int row_bytes =
      std::is_same<KV, uint8_t>::value ? a.d / 2 : a.d * (int)sizeof(KV);
  const size_t smem = mma_smem<KV, DP>(row_bytes);
  cudaError_t err = prepare_smem(paged_prefill_kernel_mma<KV, DP>, smem);
  if (err != cudaSuccess) return err;
  const int64_t rows = (int64_t)a.s_len * n_rep;
  dim3 grid((unsigned)((rows + kRows - 1) / kRows), a.hkv, a.batch);
  paged_prefill_kernel_mma<KV, DP><<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.kv_len), static_cast<const int*>(a.q_offset),
      static_cast<__nv_bfloat16*>(a.out), a.s_len, a.num_pages, a.page_size,
      a.hkv, n_rep, a.d, a.max_pages, a.sliding_window,
      a.scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// bf16 q: the tensor-core kernel at the smallest padded head dim that
// holds d, the CUDA-core kernel above 256.
template <typename KV>
cudaError_t launch_bf16(const Args& a) {
  if (a.d <= 64) return launch_mma_dp<KV, 64>(a);
  if (a.d <= 128) return launch_mma_dp<KV, 128>(a);
  if (a.d <= 256) return launch_mma_dp<KV, 256>(a);
  return launch_scalar<__nv_bfloat16, KV>(a);
}

cudaError_t launch_kind(int dtype, int kv_kind, const Args& a) {
  if (kv_kind != kKvFloat &&
      ((a.k_scale == nullptr) || (a.v_scale == nullptr)))
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (kv_kind == kKvFloat) return launch_scalar<float, float>(a);
    if (kv_kind == kKvInt8) return launch_scalar<float, int8_t>(a);
    if (kv_kind == kKvInt4) return launch_scalar<float, uint8_t>(a);
  } else if (dtype == 1) {
    if (kv_kind == kKvFloat) return launch_bf16<__nv_bfloat16>(a);
    if (kv_kind == kKvInt8) return launch_bf16<int8_t>(a);
    if (kv_kind == kKvInt4) return launch_bf16<uint8_t>(a);
  }
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
  return tpuinf::launch_kind(dtype, kv_kind, a);
}
