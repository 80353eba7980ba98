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
// A row is a (query position, GQA head) pair, so one K/V tile serves all
// n_rep heads of its kv-head. Every kernel walks keys from the window
// start of its first row to min(kv_len, last query + 1): key tiles
// wholly outside are never loaded, page ids are clamped into the pool,
// and the element mask runs only on tiles that cross a boundary. Blocks
// are numbered so the last query tiles of a chunk (the most keys) start
// first. The caller's plan (kernels/prefill_attention.py prefill_plan,
// a function of S, n_rep, head_dim, the pool kind and q's dtype only)
// picks one of four paths; the entry point refuses a path that does not
// fit its operands and never picks another.
//
// Quantized pools, on both tensor-core paths: the K and V tiles hold the
// codes, exact in bf16; K's per-key scale joins the float32 scores and
// V's the float32 P, which enters P.V as two bf16 halves, hi and the
// remainder lo (split_bf16), so p x scale keeps ~16 bits. Rounded once
// to bf16, as code x scale was before, it can flip an output's final
// bf16 rounding against the float32 reference: one ulp, 2^-5 at
// |out| >= 4, above the 2e-2 tolerance (the plan's int4 edge shapes hit
// it). A bf16 pool's P is rounded once.
//
// Path "wgmma", bf16 q at head_dim 64 or 128 when a lane's S x n_rep
// rows fill a 128-row tile (paged_prefill_kernel_wgmma): one block per
// (128-row tile, kv-head, sequence) of three warpgroups. Two consumer
// warpgroups own 64 rows each; the third is the producer, which gives
// its registers back (setmaxnreg) and fills a ring of 64-key K/V tiles in
// shared memory (four stages; three for quantized pools), tracked by
// full/empty mbarriers. Q (loaded once) and the ring hold bf16 in the
// 128-byte swizzled layout wgmma reads. S = Q.K^T is wgmma m64n64k16 with
// both operands in shared memory (K-major); O += P.V is wgmma m64nDk16
// with P from registers (the accumulator's layout is the A fragment's)
// and V read through the descriptor's MN-major mode, so V is never
// transposed. Each consumer overlaps its softmax of tile i with its P.V
// of tile i - 1 on the tensor cores, and its S of tile i + 1 with the
// issue of tile i's P.V; the two warpgroups interleave on the SM's
// schedulers. The producer follows the block table itself, one key row
// per 16-byte cp.async (a key past the walk's end is zero-filled), keeps
// stages - 1 tiles in flight and signals each stage full as soon as its
// own copies land, after a proxy fence. Not TMA: a page is pg rows of
// one kv-head strided by Hkv * D, so a tensor map per pool would have to
// be encoded on the host at every call, with 128-byte boxes of pg rows,
// and quantized pools need the producer's registers anyway. For those
// the producer copies codes and scales into a two-stage staging ring and
// converts its own pieces into the bf16 stage (attention_common.cuh,
// exact, no conversion instructions): conversion is off the consumers'
// path.
//
// Path "mma", bf16 q at head_dim up to 256 otherwise - verify rounds,
// hybrid steps, short chunks (paged_prefill_kernel_mma): one block per
// (64-row tile, kv-head, sequence) of 4 warps, each owning 16 rows. Q
// sits in shared memory as bf16 (head dim padded to 64, 128 or 256 with
// zeros, rows padded by 16 bytes so ldmatrix is free of bank conflicts)
// and is loaded once. Each iteration takes 64 keys, every key row
// followed through the block table and copied with cp.async, 16 bytes
// per thread, the next tile's copies in flight while the current one
// computes (two stages). S = Q.K^T and O += P.V are mma.sync.m16n8k16
// bf16 -> f32 fed by ldmatrix (ldmatrix.trans for V); the online softmax
// stays in registers (each thread holds two rows' (m, l), the row max
// reduced over the quad that shares a row) and P's halves become the A
// operands of P.V directly. Quantized pools: the codes (and scales) of a
// tile land in a staging buffer through cp.async, then the warps convert
// them into the bf16 tile the tensor cores read.
//
// Path "simt", float32 q at head_dim up to 256
// (paged_prefill_kernel_simt): the CUDA cores, since TF32 would not hold
// float32 to its 1e-4 tolerance. One block of 256 threads per (64-row
// tile, kv-head, sequence) walks 64-key tiles; each thread owns a 4 x 4
// block of scores (rows tr + 16i, keys tc + 16j) and the same 4 rows of
// the output over head_dim / 16 columns, so every float4 read from
// shared memory feeds 4 to 16 FMAs. The row max and sum reduce across
// the 16 threads that share a row by shuffles. K rows are padded by 4
// floats (float4 reads of 8 keys in one phase hit distinct banks); P
// reuses K's buffer once the scores are taken. A tile's V copy is in flight
// while its scores are computed.
//
// Path "wide", head_dim above 256 in either q type
// (paged_prefill_kernel_wide): one block per (64 / n_rep queries,
// kv-head, sequence) walks the pages; each page's K/V tile is loaded
// into shared memory as float32 (load_page_tile), threads over (row,
// token) compute scores with scalar FMAs, one thread per row folds the
// page into (m, l), threads over (row, d) rescale acc. None of the
// served models has such heads.

#include "attention_common.cuh"

namespace tpuinf {
namespace {

// ------------------------------------------------------------------------
// Tensor-core kernel (bf16 q).

// P for P.V as two bf16 halves, hi = bf16(p) and lo = bf16(p - hi): the
// tensor cores take bf16, and hi + lo carries p to ~2^-16 where hi alone
// rounds it to 2^-9, which on rows near |out| >= 4 flips the output's
// final bf16 rounding (one ulp, 2^-5) against the float32 reference.
// x in the low half (lower column), as pack_bf16.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(x, y);
  const __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&hi);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

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
         6 * kKeys * sizeof(float);
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
  float* tile_scales = scales + 4 * kKeys;  // [K, V][keys] of the tile
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

  // Convert stage `st`'s codes into the bf16 K/V tile, exactly (|code|
  // <= 128), their scales kept beside the tile: K's multiply the scores,
  // V's the float32 P before its split.
  auto dequant = [&](int st) {
    for (int i = tid; i < 2 * kKeys * cpr; i += kMmaThreads) {
      const int kv_row = i / cpr;  // 0..2*keys-1: K rows then V rows
      const int c = i - kv_row * cpr;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          codes + (st * 2 * kKeys + kv_row) * row_bytes + c * 16);
      __nv_bfloat16* dst = tiles + kv_row * S;
      uint32_t lo[8], hi[8];
      codes_to_bf16<kPacked>(raw, lo, hi);
      uint4* a = reinterpret_cast<uint4*>(dst + c * 16);
      a[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      a[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      if constexpr (kPacked) {
        uint4* z = reinterpret_cast<uint4*>(dst + c * 16 + d / 2);
        z[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        z[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
      }
    }
    if (tid < 2 * kKeys) tile_scales[tid] = scales[st * 2 * kKeys + tid];
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

    // A warp whose 16 rows are all past the chunk (most of the tile at
    // verify widths) skips the products; it still loads and syncs.
    if (wrow < n_real) {
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
          ldmatrix_x4(bb,
                      kt + (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * S +
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
            sum += p;
            // A quantized pool's V scale joins P in float32 (V holds
            // codes), after the row sum.
            if constexpr (kQuant)
              s[n][e] = p * tile_scales[kKeys + n * 8 + 2 * tq + (e & 1)];
            else
              s[n][e] = p;
          }
        }
        l[i] = l[i] * alpha + sum;
#pragma unroll
        for (int n = 0; n < kDN; ++n) {
          o[n][2 * i] *= alpha;
          o[n][2 * i + 1] *= alpha;
        }
      }

      // O += P.V: P's bf16 halves (from registers) are the A operands.
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const float x = s[2 * j + (q4 >> 1)][2 * (q4 & 1)];
          const float y = s[2 * j + (q4 >> 1)][2 * (q4 & 1) + 1];
          if constexpr (kQuant)
            split_bf16(x, y, ph[q4], pl[q4]);
          else
            ph[q4] = pack_bf16(x, y);
        }
#pragma unroll
        for (int dn = 0; dn < DP / 16; ++dn) {
          uint32_t bb[4];
          ldmatrix_x4_trans(
              bb, vt + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S +
                      dn * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dn], ph, bb[0], bb[1]);
          mma_bf16(o[2 * dn + 1], ph, bb[2], bb[3]);
          if constexpr (kQuant) {
            mma_bf16(o[2 * dn], pl, bb[0], bb[1]);
            mma_bf16(o[2 * dn + 1], pl, bb[2], bb[3]);
          }
        }
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
// Hopper primitives of the long-query kernel: mbarriers, proxy fences,
// register reallocation, wgmma and its shared-memory descriptors.

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t addr,
                                              unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait until the barrier's phase of this parity has completed. A wait
// past ~2^34 cycles (about 10 s) can only be a deadlock: trap, so the
// launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}
// Generic-proxy writes to shared memory (cp.async, st.shared) become
// visible to the async proxy (wgmma's operand reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Orders later reads and writes of accumulator registers after the last
// wgmma_wait (the compiler otherwise sees them as ready at issue).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The same for the A fragments a wgmma reads from registers.
__device__ __forceinline__ void fence_pa(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// 2^x on the special-function unit (one instruction; relative error
// ~2^-22, far inside the bf16 products' rounding).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d[32] (+)= A.B: A (64 x 16) and B (16 x 64) both K-major in
// shared memory (128-byte swizzle); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] += A.B: A (64 x 16 bf16) from registers in the mma.sync
// fragment layout, B (16 x 64) MN-major in shared memory (128-byte
// swizzle).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A.B: A (64 x 16 bf16) from registers in the mma.sync
// fragment layout, B (16 x 128) MN-major in shared memory (128-byte
// swizzle).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// A [64 rows, D] bf16 tile in the layout wgmma reads with a 128-byte
// swizzle: 64-column chunks of 64 rows x 128 bytes (kChunk bytes, 1024-
// byte aligned), the 16-byte group g of row r at group g ^ (r % 8).
constexpr int kChunk = 64 * 128;
__device__ __forceinline__ int swizzled(int r, int g) {
  return (g >> 3) * kChunk + r * 128 + (((g & 7) ^ (r & 7)) << 4);
}

// ------------------------------------------------------------------------
// Long-query tensor-core kernel (path "wgmma").

constexpr int kWg = 128;                 // threads of a warpgroup
constexpr int kLqThreads = 3 * kWg;      // consumers 0, 1; producer 2
constexpr int kLqRows = 2 * 64;          // M tile: (query, GQA head) rows
constexpr int kLqKeys = 64;              // keys per ring stage

// Ring stages: four for a bf16 pool (the producer keeps two tiles' copies
// in flight behind the one it signals), three for quantized pools (whose
// codes have a two-stage ring of their own).
template <typename KV>
__host__ __device__ constexpr int lq_stages() {
  return std::is_same<KV, __nv_bfloat16>::value ? 4 : 3;
}

// Shared memory of the long-query kernel, in bytes: 1024 of alignment
// slack, Q of both consumers, the ring (K and V tiles, their scales),
// the quantized pools' two code stages, the mbarriers.
template <typename KV, int DP>
constexpr size_t lq_smem() {
  constexpr bool kQuant = !std::is_same<KV, __nv_bfloat16>::value;
  constexpr size_t rb = std::is_same<KV, uint8_t>::value ? DP / 2 : DP;
  constexpr size_t tile = (DP / 64) * kChunk;
  constexpr size_t stages = lq_stages<KV>();
  return 1024 + 2 * tile + stages * 2 * tile +
         stages * 2 * kLqKeys * sizeof(float) +
         (kQuant ? 2 * 2 * kLqKeys * (rb + sizeof(float)) : 0) +
         2 * stages * sizeof(uint64_t);
}

template <typename KV, int DP>
__global__ void __launch_bounds__(kLqThreads, 1) paged_prefill_kernel_wgmma(
    const __nv_bfloat16* __restrict__ q,  // [B, S, Hq, D]
    const KV* __restrict__ k_pages,       // [P, pg, Hkv, D or D/2]
    const KV* __restrict__ v_pages,       // [P, pg, Hkv, D or D/2]
    const float* __restrict__ k_scale,    // [P, pg, Hkv] or null
    const float* __restrict__ v_scale,    // [P, pg, Hkv] or null
    const int* __restrict__ block_tables, // [B, MP]
    const int* __restrict__ kv_len,       // [B]
    const int* __restrict__ q_offset,     // [B]
    __nv_bfloat16* __restrict__ out,      // [B, S, Hq, D]
    int s_len, int n_row_tiles, int num_pages, int page_size, int hkv,
    int n_rep, int max_pages, int sliding_window, float scale_log2) {
  constexpr bool kQuant = !std::is_same<KV, __nv_bfloat16>::value;
  constexpr bool kPacked = std::is_same<KV, uint8_t>::value;
  constexpr int kTile = (DP / 64) * kChunk;  // bytes of a 64-row tile
  constexpr int kRb = kPacked ? DP / 2 : DP * (int)sizeof(KV);  // row bytes
  constexpr int kLqStages = lq_stages<KV>();

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* q_tiles = base;                // [consumer][kTile]
  unsigned char* ring = base + 2 * kTile;       // [stage][K, V][kTile]
  float* ring_scales =
      reinterpret_cast<float*>(ring + kLqStages * 2 * kTile);  // [st][2][64]
  unsigned char* codes = reinterpret_cast<unsigned char*>(
      ring_scales + kLqStages * 2 * kLqKeys);   // [2][K, V][64][kRb]
  float* code_scales = reinterpret_cast<float*>(
      codes + (kQuant ? 2 * 2 * kLqKeys * kRb : 0));  // [2][K, V][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      code_scales + (kQuant ? 2 * 2 * kLqKeys : 0));
  uint64_t* empty = full + kLqStages;

  // Heaviest tiles first: blockIdx.x runs over (kv-head, sequence),
  // blockIdx.y over row tiles from the last.
  const int tile = n_row_tiles - 1 - blockIdx.y;
  const int b = blockIdx.x / hkv;
  const int h = blockIdx.x - b * hkv;
  const int tid = threadIdx.x;
  const int wg = tid / kWg;
  const int R = n_rep;
  const int hq = hkv * R;
  const int row0 = tile * kLqRows;
  const int n_real = min(kLqRows, s_len * R - row0);

  const int len = min(kv_len[b], max_pages * page_size);
  const int qoff = q_offset[b];
  const int q_lo = qoff + row0 / R;                 // first real query
  const int q_hi = qoff + (row0 + n_real - 1) / R;  // last real query
  const int k_first = sliding_window > 0 ? max(q_lo - sliding_window + 1, 0)
                                         : 0;
  const int k_end = min(len, q_hi + 1);  // keys at or past this are masked
  const int n_tiles = k_end > k_first
                          ? (k_end - k_first + kLqKeys - 1) / kLqKeys
                          : 0;
  const int* bt = block_tables + (int64_t)b * max_pages;

  if (tid == 0) {
    for (int s = 0; s < kLqStages; ++s) {
      mbar_init(&full[s], kWg);  // every producer thread arrives
      mbar_init(&empty[s], 8);   // every consumer warp arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- Producer warpgroup: fill the ring.
    setmaxnreg_dec<kQuant ? 72 : 56>();
    const int pt = tid - 2 * kWg;
    // Pool row ((page * pg + slot) * Hkv + h) of key `pos`.
    auto pool_row = [&](int pos) -> int64_t {
      const int page = checked_page(bt, pos / page_size, num_pages);
      return ((int64_t)page * page_size + pos % page_size) * hkv + h;
    };
    const unsigned char* k_bytes =
        reinterpret_cast<const unsigned char*>(k_pages);
    const unsigned char* v_bytes =
        reinterpret_cast<const unsigned char*>(v_pages);
    if constexpr (!kQuant) {
      // Each thread copies its pieces of a tile into its stage (16 bytes
      // of key rows r0, r0 + 8, ..., all at column piece c), keeping
      // kAhead = stages - 1 tiles in flight; a stage is signalled full as
      // soon as this thread's copies of it have landed and are fenced for
      // the async proxy (every producer thread arrives). Issuing tile
      // it + kAhead then waits for tile it - 1's stage, which the
      // consumers free in their iteration it, once tile it is signalled:
      // no deadlock.
      constexpr int kPieces = DP / 8;          // 16-byte pieces per row
      constexpr int kRowStep = kWg / kPieces;  // rows between a thread's
      constexpr int kRowsPer = kLqKeys / kRowStep;
      constexpr int kAhead = kLqStages - 1;
      const int r0 = pt / kPieces;
      const int c = pt - r0 * kPieces;
      const int dst0 = swizzled(r0, c);  // + kRowStep * 128 per row
      auto issue = [&](int it) {
        if (it < n_tiles) {
          const int st = it % kLqStages;
          if (it >= kLqStages)
            mbar_wait(&empty[st], ((it / kLqStages) & 1) ^ 1);
          unsigned char* kt = ring + st * 2 * kTile;
          int pos = k_first + it * kLqKeys + r0;
          int page_i = pos / page_size;
          int slot = pos - page_i * page_size;
#pragma unroll
          for (int j = 0; j < kRowsPer; ++j) {
            const bool ok = pos < k_end;
            int64_t off = 0;
            if (ok) {
              const int page = checked_page(bt, page_i, num_pages);
              off = (((int64_t)page * page_size + slot) * hkv + h) * kRb +
                    c * 16;
            }
            // Row r0 + kRowStep j: the swizzle's row term (r & 7) is
            // r0's, since kRowStep is a multiple of 8.
            const int dst = dst0 + j * kRowStep * 128;
            cp_async16(kt + dst, k_bytes + off, ok);
            cp_async16(kt + kTile + dst, v_bytes + off, ok);
            pos += kRowStep;
            slot += kRowStep;
            while (slot >= page_size) {
              slot -= page_size;
              ++page_i;
            }
          }
        }
        cp_async_commit();
      };
      for (int it = 0; it < kAhead; ++it) issue(it);
      for (int it = 0; it < n_tiles; ++it) {
        cp_async_wait<kAhead - 1>();  // tile `it` landed
        fence_proxy_async();
        mbar_arrive(&full[it % kLqStages]);
        issue(it + kAhead);
      }
    } else {
      // Codes and scales of tile `it` land in code stage it % 2 (two
      // tiles in flight); each thread converts exactly the pieces it
      // copied, so no other thread's copies are awaited, and moves the
      // one scale it copied into the ring.
      constexpr int kPieces = kRb / 16;
      constexpr int kPer = kLqKeys * kPieces / kWg;
      const int skey = pt & (kLqKeys - 1);  // the scale this thread copies
      const int sv = pt / kLqKeys;          // 0: K's, 1: V's
      auto issue = [&](int it) {
        if (it < n_tiles) {
          const int cs = it & 1;
          unsigned char* ck = codes + cs * 2 * kLqKeys * kRb;
          const int k0 = k_first + it * kLqKeys;
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const int i = pt + kWg * j;
            const int r = i / kPieces;
            const int c = i - r * kPieces;
            const int pos = k0 + r;
            const bool ok = pos < k_end;
            const int64_t off = ok ? pool_row(pos) * kRb + c * 16 : 0;
            cp_async16(ck + r * kRb + c * 16, k_bytes + off, ok);
            cp_async16(ck + (kLqKeys + r) * kRb + c * 16, v_bytes + off, ok);
          }
          const int pos = k0 + skey;
          const bool ok = pos < k_end;
          cp_async4(code_scales + (cs * 2 + sv) * kLqKeys + skey,
                    (sv ? v_scale : k_scale) + (ok ? pool_row(pos) : 0), ok);
        }
        cp_async_commit();
      };
      issue(0);
      issue(1);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kLqStages;
        const int cs = it & 1;
        cp_async_wait<1>();  // this thread's copies of tile `it` landed
        if (it >= kLqStages)
          mbar_wait(&empty[st], ((it / kLqStages) & 1) ^ 1);
        unsigned char* kt = ring + st * 2 * kTile;
        const unsigned char* ck = codes + cs * 2 * kLqKeys * kRb;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int i = pt + kWg * j;
          const int r = i / kPieces;
          const int c = i - r * kPieces;
#pragma unroll
          for (int kv = 0; kv < 2; ++kv) {
            const uint4 raw = *reinterpret_cast<const uint4*>(
                ck + (kv * kLqKeys + r) * kRb + c * 16);
            uint32_t lo[8], hi[8];
            codes_to_bf16<kPacked>(raw, lo, hi);
            unsigned char* t = kt + kv * kTile;
            *reinterpret_cast<uint4*>(t + swizzled(r, 2 * c)) =
                make_uint4(lo[0], lo[1], lo[2], lo[3]);
            *reinterpret_cast<uint4*>(t + swizzled(r, 2 * c + 1)) =
                make_uint4(lo[4], lo[5], lo[6], lo[7]);
            if constexpr (kPacked) {
              // High nibbles: columns D/2 + 16c .. D/2 + 16c + 15.
              *reinterpret_cast<uint4*>(t + swizzled(r, DP / 16 + 2 * c)) =
                  make_uint4(hi[0], hi[1], hi[2], hi[3]);
              *reinterpret_cast<uint4*>(
                  t + swizzled(r, DP / 16 + 2 * c + 1)) =
                  make_uint4(hi[4], hi[5], hi[6], hi[7]);
            }
          }
        }
        ring_scales[(st * 2 + sv) * kLqKeys + skey] =
            code_scales[(cs * 2 + sv) * kLqKeys + skey];
        fence_proxy_async();
        mbar_arrive(&full[st]);
        issue(it + 2);
      }
    }
  } else {
    // ---- Consumer warpgroup `wg`: 64 rows.
    setmaxnreg_inc<kQuant ? 216 : 224>();
    const int ct = tid - wg * kWg;
    const int warp = ct >> 5;
    const int lane = tid & 31;
    unsigned char* qt = q_tiles + wg * kTile;
    {
      constexpr int kPieces = DP / 8;
      for (int i = ct; i < 64 * kPieces; i += kWg) {
        const int r = i / kPieces;
        const int c = i - r * kPieces;
        const int row = wg * 64 + r;
        const bool ok = row < n_real;
        const int g = row0 + row;
        const int qi = g / R;
        const int rr = g - qi * R;
        const __nv_bfloat16* src =
            ok ? q + (((int64_t)b * s_len + qi) * hq + h * R + rr) * DP +
                     c * 8
               : q;
        cp_async16(qt + swizzled(r, c), src, ok);
      }
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      named_bar_sync(1 + wg, kWg);
    }
    const uint32_t q_addr = smem_addr(qt);
    const uint32_t ring_addr = smem_addr(ring);

    // This thread's two rows (g and g + 8 of its warp's 16) and their
    // query positions; the warpgroup's first and last query.
    const int g = lane >> 2;
    const int tq = lane & 3;
    const int wrow = wg * 64 + warp * 16;
    int qpos[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) qpos[i] = qoff + (row0 + wrow + g + 8 * i) / R;
    const int wq_lo = qoff + (row0 + wg * 64) / R;
    const int wq_hi = qoff + (row0 + wg * 64 + 63) / R;

    // Accumulators are written outside a wgmma only between a wait and
    // the next issue, each write pinned there by fence_regs: a write the
    // compiler sank into a stage in flight would serialize the wgmmas.
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(o);
    fence_regs(s);
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's share; quad-reduced at the end
    // P of the tile in P.V as A fragments (a quantized pool's in two
    // bf16 halves, pa and pl).
    uint32_t pa[4][4] = {}, pl[4][4] = {};

    // S = Q.K^T of stage `st` into acc (one commit group).
    auto issue_s = [&](float (&acc)[32], int st) {
      const uint32_t k_addr = ring_addr + st * 2 * kTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk >> 2) * kChunk + (kk & 3) * 32;
        wgmma_ss_n64(acc, gmma_desc(q_addr + off, 16, 1024),
                     gmma_desc(k_addr + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O += P.V of stage `st` (one commit group): V [64 keys, D] is the
    // MN-major B operand, 16 keys (2048 bytes) per k-step, the next
    // 64-column chunk kChunk bytes on.
    auto issue_pv = [&](const uint32_t (&ph)[4][4],
                        const uint32_t (&pl)[4][4], int st) {
      const uint32_t v_addr = ring_addr + st * 2 * kTile + kTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t desc = gmma_desc(v_addr + kk * 2048, kChunk, 1024);
        if constexpr (DP == 128) {
          wgmma_rs_n128(o, ph[kk], desc);
          if constexpr (kQuant) wgmma_rs_n128(o, pl[kk], desc);
        } else {
          wgmma_rs_n64(o, ph[kk], desc);
          if constexpr (kQuant) wgmma_rs_n64(o, pl[kk], desc);
        }
      }
      wgmma_commit();
    };

    // One S accumulator: tile it + 1's S is issued once tile it's P has
    // left s for the A fragments.
    if (n_tiles > 0) {
      mbar_wait(&full[0], 0);
      issue_s(s, 0);
      wgmma_wait<0>();
      fence_regs(s);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kLqStages;
      const int k0 = k_first + it * kLqKeys;
      const float* ksc = ring_scales + st * 2 * kLqKeys;
      const float* vsc = ksc + kLqKeys;

      // Scale into the log2 domain (a quantized pool's scores take their
      // K scales too); mask only tiles that cross a boundary (kv_len, the
      // causal diagonal of the warpgroup's first query, or the window of
      // its last). Accumulator element 4j + e is row g + 8 (e >> 1), key
      // 8j + 2 tq + (e & 1).
      const bool full_tile =
          k0 + kLqKeys <= k_end && k0 + kLqKeys - 1 <= wq_lo &&
          (sliding_window <= 0 || k0 > wq_hi - sliding_window);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float2 kscale = make_float2(scale_log2, scale_log2);
        if constexpr (kQuant) {
          kscale = *reinterpret_cast<const float2*>(ksc + 8 * j + 2 * tq);
          kscale.x *= scale_log2;
          kscale.y *= scale_log2;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = 8 * j + 2 * tq + (e & 1);
          float x = s[4 * j + e] * ((e & 1) ? kscale.y : kscale.x);
          if (!full_tile) {
            const int key = k0 + kc;
            const int qp = qpos[e >> 1];
            bool valid = key < len && key <= qp;
            if (sliding_window > 0) valid = valid && key > qp - sliding_window;
            x = valid ? x : kNegInf;
          }
          s[4 * j + e] = x;
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        alpha[i] = ex2(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float2 vscale = make_float2(1.f, 1.f);
          if constexpr (kQuant)
            vscale = *reinterpret_cast<const float2*>(vsc + 8 * j + 2 * tq);
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            // Masked entries contribute nothing, even while the row's
            // max is still the mask value.
            const float x = s[4 * j + e];
            const float p = x > 0.5f * kNegInf ? ex2(x - m_new) : 0.f;
            sum += p;
            // A quantized pool's V scale joins P in float32 (V holds
            // codes), after the row sum.
            s[4 * j + e] = kQuant ? p * ((e & 1) ? vscale.y : vscale.x) : p;
          }
        }
        l[i] = l[i] * alpha[i] + sum;
      }
      // P.V of tile it - 1 (which ran beside this softmax) is done: its
      // A fragments are free, its stage goes back to the producer, and O
      // takes this tile's rescale.
      wgmma_wait<0>();
      fence_regs(o);
      fence_pa(pa);
      if constexpr (kQuant) fence_pa(pl);
      // P's bf16 halves in the A-fragment layout: k-step kk takes keys
      // 16kk .. 16kk + 15, accumulator blocks 2kk and 2kk + 1. Written
      // only here, after the wait: a wgmma reads its A registers until
      // its group completes.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const float x = s[8 * kk + 2 * q4], y = s[8 * kk + 2 * q4 + 1];
          if constexpr (kQuant)
            split_bf16(x, y, pa[kk][q4], pl[kk][q4]);
          else
            pa[kk][q4] = pack_bf16(x, y);
        }
      if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kLqStages]);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j + 0] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      fence_regs(o);
      // Issue and wait sit in one branch, so the compiler sees S complete
      // on every path back to the loop's top.
      if (it + 1 < n_tiles) {
        const int nst = (it + 1) % kLqStages;
        mbar_wait(&full[nst], ((it + 1) / kLqStages) & 1);
        issue_s(s, nst);
        issue_pv(pa, pl, st);
        wgmma_wait<1>();  // S of tile it + 1; P.V of tile it runs on
        fence_regs(s);
      } else {
        issue_pv(pa, pl, st);
      }
    }
    wgmma_wait<0>();
    fence_regs(o);

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
      const int rr = gr - qi * R;
      __nv_bfloat16* dst =
          out + (((int64_t)b * s_len + qi) * hq + h * R + rr) * DP;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(o[4 * j + 2 * i] * inv,
                                  o[4 * j + 2 * i + 1] * inv);
    }
  }
}

// ------------------------------------------------------------------------
// float32 CUDA-core kernel (path "simt").

constexpr int kSimtThreads = 256;
constexpr int kSimtRows = 64;
constexpr int kSimtKeys = 64;
constexpr int kPStride = kSimtKeys + 4;  // floats per row of P

// Shared memory of the float32 kernel, in floats: Q [64][d], K [64][d+4]
// (P [64][68] once the scores are taken), V [64][d].
__host__ __device__ inline int simt_k_floats(int d) {
  return kSimtRows * max(d + 4, kPStride);
}
inline size_t simt_smem(int d) {
  return sizeof(float) * (2 * kSimtRows * d + simt_k_floats(d));
}

// Keys k0 .. k0 + 63 of a quantized pool into K [64][d + 4] and
// V [64][d] as float32 (code times scale, as the reference dequantizes);
// keys at or past k_end are zeros. 16 bytes of codes per thread and
// load: int8 columns 16c .. 16c + 15, packed int4 the same low nibbles
// and columns D/2 + 16c .. of the high ones.
template <typename KV>
__device__ __forceinline__ void load_codes_f32(
    const KV* __restrict__ k_pages, const KV* __restrict__ v_pages,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ bt, int num_pages, int page_size, int hkv,
    int h, int d, int k0, int k_end, float* k_s, float* v_s, int tid) {
  constexpr bool kPacked = std::is_same<KV, uint8_t>::value;
  const int rb = kPacked ? d / 2 : d;
  const int pieces = rb / 16;
  const int ks = d + 4;
  for (int i = tid; i < kSimtKeys * pieces; i += kSimtThreads) {
    const int r = i / pieces;
    const int c = i - r * pieces;
    const int pos = k0 + r;
    uint4 kraw = make_uint4(0, 0, 0, 0), vraw = kraw;
    float ksc = 0.f, vsc = 0.f;
    if (pos < k_end) {
      const int page = checked_page(bt, pos / page_size, num_pages);
      const int64_t row = ((int64_t)page * page_size + pos % page_size) *
                          hkv + h;
      const int64_t off = row * rb + c * 16;
      kraw = *reinterpret_cast<const uint4*>(
          reinterpret_cast<const unsigned char*>(k_pages) + off);
      vraw = *reinterpret_cast<const uint4*>(
          reinterpret_cast<const unsigned char*>(v_pages) + off);
      ksc = k_scale[row];
      vsc = v_scale[row];
    }
    const KV* kx = reinterpret_cast<const KV*>(&kraw);
    const KV* vx = reinterpret_cast<const KV*>(&vraw);
    float* kr = k_s + r * ks + c * 16;
    float* vr = v_s + r * d + c * 16;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if constexpr (kPacked) {
        kr[j] = (float)nibble_lo(kx[j]) * ksc;
        kr[j + d / 2] = (float)nibble_hi(kx[j]) * ksc;
        vr[j] = (float)nibble_lo(vx[j]) * vsc;
        vr[j + d / 2] = (float)nibble_hi(vx[j]) * vsc;
      } else {
        kr[j] = (float)kx[j] * ksc;
        vr[j] = (float)vx[j] * vsc;
      }
    }
  }
}

template <typename KV, int DP>
__global__ void __launch_bounds__(kSimtThreads, DP <= 128 ? 2 : 1)
    paged_prefill_kernel_simt(
        const float* __restrict__ q,          // [B, S, Hq, D]
        const KV* __restrict__ k_pages,       // [P, pg, Hkv, D or D/2]
        const KV* __restrict__ v_pages,       // [P, pg, Hkv, D or D/2]
        const float* __restrict__ k_scale,    // [P, pg, Hkv] or null
        const float* __restrict__ v_scale,    // [P, pg, Hkv] or null
        const int* __restrict__ block_tables, // [B, MP]
        const int* __restrict__ kv_len,       // [B]
        const int* __restrict__ q_offset,     // [B]
        float* __restrict__ out,              // [B, S, Hq, D]
        int s_len, int n_row_tiles, int num_pages, int page_size, int hkv,
        int n_rep, int d, int max_pages, int sliding_window,
        float scale_log2) {
  constexpr bool kQuant = !std::is_same<KV, float>::value;
  constexpr int kCols = DP / 64;  // float4 column groups per thread
  extern __shared__ float4 smem_f4[];
  float* q_s = reinterpret_cast<float*>(smem_f4);  // [64][d]
  float* k_s = q_s + kSimtRows * d;                // [64][d + 4]
  float* p_s = k_s;                                // [64][68]
  float* v_s = k_s + simt_k_floats(d);             // [64][d]
  const int ks = d + 4;

  const int tile = n_row_tiles - 1 - blockIdx.y;  // heaviest tiles first
  const int b = blockIdx.x / hkv;
  const int h = blockIdx.x - b * hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tr = (tid >> 5) * 2 + (lane >> 4);  // rows tr + 16i
  const int tc = lane & 15;                     // keys tc + 16j
  const int R = n_rep;
  const int hq = hkv * R;
  const int row0 = tile * kSimtRows;
  const int n_real = min(kSimtRows, s_len * R - row0);
  const int d4 = d / 4;

  for (int i = tid; i < kSimtRows * d4; i += kSimtThreads) {
    const int r = i / d4;
    const int c = i - r * d4;
    const bool ok = r < n_real;
    const int g = row0 + r;
    const int qi = g / R;
    const int rr = g - qi * R;
    cp_async16(q_s + r * d + 4 * c,
               ok ? q + (((int64_t)b * s_len + qi) * hq + h * R + rr) * d +
                        4 * c
                  : q,
               ok);
  }
  cp_async_commit();

  const int len = min(kv_len[b], max_pages * page_size);
  const int qoff = q_offset[b];
  const int q_lo = qoff + row0 / R;
  const int q_hi = qoff + (row0 + n_real - 1) / R;
  const int k_first = sliding_window > 0 ? max(q_lo - sliding_window + 1, 0)
                                         : 0;
  const int k_end = min(len, q_hi + 1);
  const int n_tiles = k_end > k_first
                          ? (k_end - k_first + kSimtKeys - 1) / kSimtKeys
                          : 0;
  const int* bt = block_tables + (int64_t)b * max_pages;

  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = qoff + (row0 + tr + 16 * i) / R;
  float acc[4][4 * kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[i][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_first + it * kSimtKeys;
    if constexpr (kQuant) {
      load_codes_f32(k_pages, v_pages, k_scale, v_scale, bt, num_pages,
                     page_size, hkv, h, d, k0, k_end, k_s, v_s, tid);
      cp_async_wait<0>();  // Q (first tile)
    } else {
      // K, then V in a group of its own (awaited after the scores).
      for (int pass = 0; pass < 2; ++pass) {
        const float* src = pass ? v_pages : k_pages;
        float* dst = pass ? v_s : k_s;
        const int stride = pass ? d : ks;
        for (int i = tid; i < kSimtKeys * d4; i += kSimtThreads) {
          const int r = i / d4;
          const int c = i - r * d4;
          const int pos = k0 + r;
          const bool ok = pos < k_end;
          int64_t off = 0;
          if (ok) {
            const int page = checked_page(bt, pos / page_size, num_pages);
            off = (((int64_t)page * page_size + pos % page_size) * hkv + h) *
                      d + 4 * c;
          }
          cp_async16(dst + r * stride + 4 * c, src + off, ok);
        }
        cp_async_commit();
      }
      cp_async_wait<1>();  // Q and K landed; V may be in flight
    }
    __syncthreads();

    // Scores of rows tr + 16i, keys tc + 16j.
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < d; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (tr + 16 * i) * d + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_s + (tc + 16 * j) * ks + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = sc[i][j];
          x = fmaf(qv[i].x, kv[j].x, x);
          x = fmaf(qv[i].y, kv[j].y, x);
          x = fmaf(qv[i].z, kv[j].z, x);
          x = fmaf(qv[i].w, kv[j].w, x);
          sc[i][j] = x;
        }
    }
    __syncthreads();  // K's buffer holds P from here

    const bool full_tile =
        k0 + kSimtKeys <= k_end && k0 + kSimtKeys - 1 <= q_lo &&
        (sliding_window <= 0 || k0 > q_hi - sliding_window);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = sc[i][j] * scale_log2;
        if (!full_tile) {
          const int key = k0 + tc + 16 * j;
          bool valid = key < len && key <= qpos[i];
          if (sliding_window > 0)
            valid = valid && key > qpos[i] - sliding_window;
          x = valid ? x : kNegInf;
        }
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = sc[i][j];
        const float p = x > 0.5f * kNegInf ? exp2f(x - m_new) : 0.f;
        p_s[(tr + 16 * i) * kPStride + tc + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < 4 * kCols; ++c) acc[i][c] *= alpha;
    }
    if constexpr (!kQuant) cp_async_wait<0>();
    __syncthreads();  // P and V visible

#pragma unroll 2
    for (int k = 0; k < kSimtKeys; k += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(
            p_s + (tr + 16 * i) * kPStride + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* vr = v_s + (k + kk) * d;
#pragma unroll
        for (int cg = 0; cg < kCols; ++cg) {
          const int col = 4 * (tc + 16 * cg);
          if (col < d) {
            const float4 v = *reinterpret_cast<const float4*>(vr + col);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = kk == 0   ? p4[i].x
                              : kk == 1 ? p4[i].y
                              : kk == 2 ? p4[i].z
                                        : p4[i].w;
              acc[i][4 * cg + 0] = fmaf(p, v.x, acc[i][4 * cg + 0]);
              acc[i][4 * cg + 1] = fmaf(p, v.y, acc[i][4 * cg + 1]);
              acc[i][4 * cg + 2] = fmaf(p, v.z, acc[i][4 * cg + 2]);
              acc[i][4 * cg + 3] = fmaf(p, v.w, acc[i][4 * cg + 3]);
            }
          }
        }
      }
    }
    __syncthreads();  // K/P and V buffers free for the next tile
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = tr + 16 * i;
    if (row >= n_real) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // no valid key: 0
    const int gr = row0 + row;
    const int qi = gr / R;
    const int rr = gr - qi * R;
    float* dst = out + (((int64_t)b * s_len + qi) * hq + h * R + rr) * d;
#pragma unroll
    for (int cg = 0; cg < kCols; ++cg) {
      const int col = 4 * (tc + 16 * cg);
      if (col < d)
        *reinterpret_cast<float4*>(dst + col) = make_float4(
            acc[i][4 * cg] * inv, acc[i][4 * cg + 1] * inv,
            acc[i][4 * cg + 2] * inv, acc[i][4 * cg + 3] * inv);
    }
  }
}

// ------------------------------------------------------------------------
// Wide-head CUDA-core kernel (path "wide": head_dim above 256).

constexpr int kThreads = 256;
constexpr int kTileRows = 64;

template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel_wide(
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

// Paths (the plan's `path` argument).
enum Path { kPathSimt = 0, kPathMma = 1, kPathWgmma = 2, kPathWide = 3 };

// The grid of the tiled kernels: x over (kv-head, sequence), y over row
// tiles of `rows` rows (x = 0 when it does not fit).
inline dim3 tile_grid(const Args& a, int rows) {
  const int64_t tiles =
      ((int64_t)a.s_len * (a.hq / a.hkv) + rows - 1) / rows;
  const int64_t heads = (int64_t)a.hkv * a.batch;
  if (tiles > 65535 || heads > 0x7fffffff) return dim3(0, 1);
  return dim3((unsigned)heads, (unsigned)tiles);
}

template <typename T, typename KV>
cudaError_t launch_wide(const Args& a) {
  const int n_rep = a.hq / a.hkv;
  const int block_q = max(1, kTileRows / n_rep);
  const size_t rows = (size_t)block_q * n_rep;
  const size_t d = a.d, pg = a.page_size;
  const size_t smem = sizeof(float) * (rows * (d + 1) + rows * d +
                                       pg * (d + 1) + pg * d + rows * pg +
                                       3 * rows);
  cudaError_t err = prepare_smem(paged_prefill_kernel_wide<T, KV>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.s_len + block_q - 1) / block_q, a.hkv, a.batch);
  paged_prefill_kernel_wide<T, KV><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.kv_len), static_cast<const int*>(a.q_offset),
      static_cast<T*>(a.out), a.s_len, block_q, a.num_pages, a.page_size,
      a.hkv, n_rep, a.d, a.max_pages, a.sliding_window, a.scale);
  return cudaGetLastError();
}

template <typename KV, int DP>
cudaError_t launch_simt_dp(const Args& a) {
  const dim3 grid = tile_grid(a, kSimtRows);
  if (grid.x == 0) return cudaErrorInvalidValue;
  const size_t smem = simt_smem(a.d);
  cudaError_t err = prepare_smem(paged_prefill_kernel_simt<KV, DP>, smem);
  if (err != cudaSuccess) return err;
  const int n_rep = a.hq / a.hkv;
  paged_prefill_kernel_simt<KV, DP><<<grid, kSimtThreads, smem,
                                      a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.kv_len), static_cast<const int*>(a.q_offset),
      static_cast<float*>(a.out), a.s_len, (int)grid.y, a.num_pages,
      a.page_size, a.hkv, n_rep, a.d, a.max_pages, a.sliding_window,
      a.scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename KV>
cudaError_t launch_simt(const Args& a) {
  if (a.d <= 64) return launch_simt_dp<KV, 64>(a);
  if (a.d <= 128) return launch_simt_dp<KV, 128>(a);
  if (a.d <= 256) return launch_simt_dp<KV, 256>(a);
  return cudaErrorInvalidValue;
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

// The smallest padded head dim that holds d.
template <typename KV>
cudaError_t launch_mma(const Args& a) {
  if (a.d <= 64) return launch_mma_dp<KV, 64>(a);
  if (a.d <= 128) return launch_mma_dp<KV, 128>(a);
  if (a.d <= 256) return launch_mma_dp<KV, 256>(a);
  return cudaErrorInvalidValue;
}

template <typename KV, int DP>
cudaError_t launch_wgmma_dp(const Args& a) {
  const dim3 grid = tile_grid(a, kLqRows);
  if (grid.x == 0) return cudaErrorInvalidValue;
  const size_t smem = lq_smem<KV, DP>();
  cudaError_t err = prepare_smem(paged_prefill_kernel_wgmma<KV, DP>, smem);
  if (err != cudaSuccess) return err;
  paged_prefill_kernel_wgmma<KV, DP><<<grid, kLqThreads, smem,
                                       a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.kv_len), static_cast<const int*>(a.q_offset),
      static_cast<__nv_bfloat16*>(a.out), a.s_len, (int)grid.y,
      a.num_pages, a.page_size, a.hkv, a.hq / a.hkv, a.max_pages,
      a.sliding_window,
      a.scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// Head dims of exactly 64 or 128: whole 64-column swizzle chunks.
template <typename KV>
cudaError_t launch_wgmma(const Args& a) {
  if (a.d == 64) return launch_wgmma_dp<KV, 64>(a);
  if (a.d == 128) return launch_wgmma_dp<KV, 128>(a);
  return cudaErrorInvalidValue;
}

// The path's launcher for q's type and the pool kind; a path that does
// not fit them is refused (cudaErrorInvalidValue), never replaced.
template <typename KV>
cudaError_t launch_path(int dtype, int path, const Args& a) {
  if (dtype == 0) {
    if (path == kPathSimt)
      return launch_simt<std::conditional_t<
          std::is_same<KV, __nv_bfloat16>::value, float, KV>>(a);
    if (path == kPathWide)
      return launch_wide<float, std::conditional_t<
          std::is_same<KV, __nv_bfloat16>::value, float, KV>>(a);
    return cudaErrorInvalidValue;
  }
  if (path == kPathMma) return launch_mma<KV>(a);
  if (path == kPathWgmma) return launch_wgmma<KV>(a);
  if (path == kPathWide) return launch_wide<__nv_bfloat16, KV>(a);
  return cudaErrorInvalidValue;
}

cudaError_t launch_kind(int dtype, int kv_kind, int path, const Args& a) {
  if (kv_kind != kKvFloat &&
      ((a.k_scale == nullptr) || (a.v_scale == nullptr)))
    return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  // KV names the pool's stored type; a float pool is q's type.
  if (kv_kind == kKvFloat) return launch_path<__nv_bfloat16>(dtype, path, a);
  if (kv_kind == kKvInt8) return launch_path<int8_t>(dtype, path, a);
  if (kv_kind == kKvInt4) return launch_path<uint8_t>(dtype, path, a);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace tpuinf

// dtype (of q and out): 0 = float32, 1 = bfloat16. kv_kind: 0 = pool in
// q's type (scales unused), 1 = int8 codes, 2 = packed int4 codes in
// uint8, both with float32 scales. path: 0 "simt", 1 "mma", 2 "wgmma",
// 3 "wide" (kernels/prefill_attention.py prefill_plan). Returns a
// cudaError_t (0 = launched).
extern "C" int paged_prefill_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* kv_len, const void* q_offset, void* out, int dtype,
    int kv_kind, int path, int batch, int s_len, int hq, int hkv, int d,
    int num_pages, int page_size, int max_pages, int sliding_window,
    float scale, void* stream) {
  const tpuinf::Args a{q, k_pages, v_pages, k_scale, v_scale,
                       block_tables, kv_len, q_offset, out, batch, s_len,
                       hq, hkv, d, num_pages, page_size, max_pages,
                       sliding_window, scale,
                       static_cast<cudaStream_t>(stream)};
  return tpuinf::launch_kind(dtype, kv_kind, path, a);
}
