// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_inference/kernels/paged_attention.py
// _decode_kernel (launched by paged_attention): one query token per
// sequence attends over its KV pages, followed through
// block_tables[b, p] (page 0 = trash page), with online softmax (m, l,
// acc) in float32, positions >= kv_len masked, GQA folded in (each KV
// head serves its n_rep query heads) and an optional sliding window.
// The pool holds q's type, or int8 codes, or packed int4 codes (uint8),
// the quantized kinds with per-(token, head) float32 scales.
//
// What bounds it on this card: bytes. Each sequence's K and V pages are
// read once per step and every element feeds 2 * n_rep flops, about 4
// flops per bf16 byte at n_rep 4, far under the ~295 the H100 needs
// before its tensor cores become the limit (3.35 TB/s HBM). int8 codes
// halve those bytes and int4 quarters them (plus 4 bytes of scale per
// token and head). The only gains are filling the card and keeping
// enough loads in flight to stream HBM.
//
// Design: split-KV. The grid is B x Hkv x (row groups) x NS blocks, the
// kv-heads of one token range side by side; a block owns one (sequence,
// kv-head), its GQA query rows (up to 16, or 8 in the float32 kernel)
// and a contiguous range of pages_per_split pages, counted from the
// window's first page under a sliding window. The host picks NS and
// pages_per_split from the table width, page size and window alone
// (kernels/paged_attention.py split_plan): never from the batch, so a
// lane's partials and their merge order are the same at every batch
// width, and never from kv_len, which lives on the device. Each block
// reads kv_len first and counts the splits of its sequence that hold any
// token: a block past them exits at once, having read and written
// nothing.
//
// Inside a block each of 4 warps works alone on its chunks of the range
// (chunk w, w + 4, ...): a two-stage cp.async ring per warp keeps the
// next chunk's K/V rows (16 bytes per copy; each token's page followed
// through the block table, clamped into the pool, read one chunk ahead)
// in flight while the current one computes, so no __syncthreads runs per
// page. bf16 q (paged_decode_kernel_mma, head dims up to 256): the query
// rows, padded to one 16-row tile, meet 16 keys at a time on the tensor
// cores, S = Q.K^T and O += P.V with mma.sync.m16n8k16 (bf16 in, float32
// out) fed by ldmatrix, the online softmax in registers. A chunk holds
// 16 tokens of a bf16 pool and 32 of int8 or int4 codes (about 8 KB at
// head dim 128 either way); codes become bf16 in shared memory without
// conversion instructions (attention_common.cuh): K codes exactly, their
// scale multiplying the float32 score; V codes times their scale in
// float32, rounded once to bf16, a rounding the reference's float32
// dequantization does not have (inside the 2e-2 tolerance). P is rounded
// to bf16 for P.V, as in prefill. float32 q (paged_decode_kernel, and
// bf16 above head dim 256): the same split and ring on the CUDA cores,
// query rows in shared memory, lanes over (token, part of the head dim)
// for the scores and over columns for P.V, codes converted in registers
// with each token's K scale on its score and V scale on its probability.
// The warps merge once at the block's end.
//
// Merge: a sequence whose tokens fit one split gets its output from that
// block. Otherwise each non-empty split writes its partial (m, l, acc[D])
// in float32 to scratch the wrapper allocates (torch.empty), counts
// itself in a per-(sequence, kv-head) counter, and the last block of the
// slot merges the partials by the log-sum-exp rule, writes the output
// and resets the counter to 0 (finish_split). This takes the place of a
// second combine kernel: the decode loop is host-bound, and a second
// launch per layer per step adds a kernel start-up to every step. The
// counters are the one buffer that must start at zero; the wrapper keeps
// one per (device, stream) and every launch leaves it at zero.

#include "attention_common.cuh"

namespace tpuinf {
namespace {

constexpr int kMaxRows = 8;  // query rows per block (row groups beyond)
constexpr int kStages = 2;   // chunks in flight per warp

// Bytes of one warp's shared memory: the K/V ring, its scales, the
// chunk's probabilities and the warp's acc.
__host__ __device__ inline size_t warp_smem(int tok, int row_bytes,
                                            int acc_rows, int d) {
  return (size_t)kStages * 2 * tok * (row_bytes + 16) +
         (size_t)kStages * 2 * tok * 4 + (size_t)kMaxRows * tok * 4 +
         (size_t)acc_rows * d * 4;
}
inline size_t decode_smem(int tok, int warps, int row_bytes, int acc_rows,
                          int d) {
  return (size_t)kMaxRows * d * 4 + (size_t)2 * warps * kMaxRows * 4 +
         warps * warp_smem(tok, row_bytes, acc_rows, d);
}

// The tokens [t_lo, t_hi) of split `split` of a (sequence, kv-head), and
// how many of its splits hold any token (n_active; splits at or past it
// are empty). Split 0 starts at the window's first page (or page 0);
// positions stop at kv_len and at the block table's reach.
struct SplitRange {
  int t_lo, t_hi, n_active;
};
__device__ __forceinline__ SplitRange split_range(int len, int split,
                                                  int page_size,
                                                  int max_pages,
                                                  int sliding_window,
                                                  int pages_per_split) {
  const int len_c = min(len, max_pages * page_size);
  const int win_lo = sliding_window > 0 ? max(len - sliding_window, 0) : 0;
  const int first = win_lo / page_size;
  const int p_lo = first + split * pages_per_split;
  SplitRange r;
  r.n_active = len_c > win_lo ? ((len_c + page_size - 1) / page_size -
                                 first + pages_per_split - 1) /
                                    pages_per_split
                              : 0;
  r.t_lo = max(p_lo * page_size, win_lo);
  r.t_hi = min((p_lo + pages_per_split) * page_size, len_c);
  return r;
}

// Split-KV epilogue of a block that wrote its partial (m, l, acc) for
// rows [out_row, out_row + nr), when its slot has n_active > 1 non-empty
// splits: count the block in the slot's counter; the last of them merges
// the n_active partials by the log-sum-exp rule into the output and
// resets the counter to 0 for the next launch. A warp merges one row:
// lane j holds split s0 + j's weight and passes it to the others by a
// shuffle. `flag` is a word of dead shared memory. Called by every thread
// of the block.
template <typename T>
__device__ void finish_split(const float* part_acc, const float* part_ml,
                             T* out, int* counter, int* flag,
                             int64_t out_row, int nr, int d, int num_splits,
                             int n_active) {
  __threadfence();  // this block's partial is visible before it counts
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == n_active - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nr; r += blockDim.x >> 5) {
    const int64_t prow = (out_row + r) * num_splits;
    float mx = kNegInf;
    for (int s = lane; s < n_active; s += 32)
      mx = fmaxf(mx, __ldcg(part_ml + (prow + s) * 2));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int s = lane; s < n_active; s += 32)
      sum += __ldcg(part_ml + (prow + s) * 2 + 1) *
             expf(__ldcg(part_ml + (prow + s) * 2) - mx);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float inv = 1.f / fmaxf(sum, 1e-20f);
    for (int c = lane; c < d + 31 - (d + 31) % 32; c += 32) {
      float a = 0.f;
      for (int s0 = 0; s0 < n_active; s0 += 32) {
        float w = 0.f;  // weight of split s0 + lane (0: past n_active)
        if (s0 + lane < n_active)
          w = expf(__ldcg(part_ml + (prow + s0 + lane) * 2) - mx) * inv;
        for (int j = 0; j < min(32, n_active - s0); ++j) {
          const float ws = __shfl_sync(0xffffffffu, w, j);
          if (ws != 0.f && c < d)
            a += ws * __ldcg(part_acc + (prow + s0 + j) * d + c);
        }
      }
      if (c < d) out[(out_row + r) * d + c] = from_f32<T>(a);
    }
  }
  if (threadIdx.x == 0) *counter = 0;
}

template <typename T, typename KV>
__global__ void __launch_bounds__(128) paged_decode_kernel(
    const T* __restrict__ q,              // [B, Hq, D]
    const KV* __restrict__ k_pages,       // [P, pg, Hkv, D or D/2]
    const KV* __restrict__ v_pages,       // [P, pg, Hkv, D or D/2]
    const float* __restrict__ k_scale,    // [P, pg, Hkv] or null
    const float* __restrict__ v_scale,    // [P, pg, Hkv] or null
    const int* __restrict__ block_tables, // [B, MP]
    const int* __restrict__ kv_len,       // [B]
    T* __restrict__ out,                  // [B, Hq, D]
    float* __restrict__ part_acc,         // [B, Hq, NS, D] (NS > 1)
    float* __restrict__ part_ml,          // [B, Hq, NS, 2] (NS > 1)
    int* __restrict__ counters,           // [B, Hkv, row groups] (NS > 1)
    int num_pages, int page_size, int hkv, int n_rep, int d, int max_pages,
    int sliding_window, float scale, int num_splits, int pages_per_split,
    int tok) {
  constexpr bool kPacked = std::is_same<KV, uint8_t>::value;
  constexpr bool kQuant = kPacked || std::is_same<KV, int8_t>::value;
  // Values in one 16-byte piece of a stored row.
  constexpr int kVec = kPacked ? 32 : 16 / (int)sizeof(KV);
  const int R = n_rep;
  const int n_groups = (R + kMaxRows - 1) / kMaxRows;
  // Block order (b, split, group, kv-head), kv-head fastest: the heads of
  // one token range run side by side and read neighbouring bytes of the
  // same pool rows ([P, pg, Hkv, D]).
  int idx = blockIdx.x;
  const int h = idx % hkv;
  idx /= hkv;
  const int grp = idx % n_groups;
  idx /= n_groups;
  const int split = idx % num_splits;
  const int b = idx / num_splits;
  const int64_t slot = ((int64_t)b * n_groups + grp) * hkv + h;
  const int r0 = grp * kMaxRows;
  const int nr = min(kMaxRows, R - r0);
  const int acc_rows = min(R, kMaxRows);
  const int hq = hkv * R;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int row_bytes = kPacked ? d / 2 : d * (int)sizeof(KV);
  const int cpr = row_bytes / 16;  // 16-byte pieces per stored row
  const int rstride = row_bytes + 16;

  const int64_t out_row = (int64_t)b * hq + h * R + r0;  // first row
  extern __shared__ __align__(16) unsigned char smem_raw[];

  // This split's tokens; a split past the last non-empty one exits at
  // once (split 0 writes zeros when no split holds a token).
  const SplitRange sr = split_range(kv_len[b], split, page_size, max_pages,
                                    sliding_window, pages_per_split);
  if (split >= sr.n_active) {
    if (split == 0)
      for (int i = tid; i < nr * d; i += blockDim.x)
        out[out_row * d + i] = from_f32<T>(0.f);
    return;
  }
  const int t_lo = sr.t_lo, t_hi = sr.t_hi;
  const int n_chunks = (t_hi - t_lo + tok - 1) / tok;

  float* q_s = reinterpret_cast<float*>(smem_raw);  // [kMaxRows][d]
  float* wm = q_s + kMaxRows * d;                   // [warps][kMaxRows]
  float* wl = wm + nwarps * kMaxRows;               // [warps][kMaxRows]
  unsigned char* warps_base =
      reinterpret_cast<unsigned char*>(wl + nwarps * kMaxRows);
  const size_t wbytes = warp_smem(tok, row_bytes, acc_rows, d);
  const size_t acc_off = wbytes - (size_t)acc_rows * d * 4;
  unsigned char* ring = warps_base + warp * wbytes;  // [st][K,V][tok][rs]
  float* sc_s = reinterpret_cast<float*>(ring + kStages * 2 * tok * rstride);
  float* p_s = sc_s + kStages * 2 * tok;            // [kMaxRows][tok]
  float* acc = reinterpret_cast<float*>(ring + acc_off);  // [rows][d]

  for (int i = tid; i < kMaxRows * d; i += blockDim.x)
    q_s[i] = i < nr * d ? to_f32(q[out_row * d + i]) : 0.f;
  for (int i = lane; i < acc_rows * d; i += 32) acc[i] = 0.f;

  const int* bt = block_tables + (int64_t)b * max_pages;
  const int my_chunks =
      n_chunks > warp ? (n_chunks - warp + nwarps - 1) / nwarps : 0;
  const int t_lane = lane & (tok - 1);  // this lane's token in a chunk
  const int part = lane / tok;          // and its share of the head dim
  const int parts = 32 / tok;

  // Pool row ((page * pg + slot) * Hkv + h) of this lane's token of chunk
  // i (token lane % tok), or -1 past the range. Loaded one chunk ahead of
  // its copies, so the block-table read's latency hides behind compute.
  auto token_row = [&](int i) -> int64_t {
    const int pos = t_lo + (warp + i * nwarps) * tok + (lane & (tok - 1));
    if (i >= my_chunks || pos >= t_hi) return -1;
    const int page = checked_page(bt, pos / page_size, num_pages);
    return ((int64_t)page * page_size + pos % page_size) * hkv + h;
  };
  // Issue this warp's chunk i into stage st (an empty group past the end);
  // `row` is token_row(i). Lane t's row reaches the lanes copying token t
  // by a shuffle.
  const unsigned char* k_bytes = reinterpret_cast<const unsigned char*>(k_pages);
  const unsigned char* v_bytes = reinterpret_cast<const unsigned char*>(v_pages);
  auto issue = [&](int i, int st, int64_t row) {
    if (i < my_chunks) {
      unsigned char* kd = ring + st * 2 * tok * rstride;
      unsigned char* vd = kd + tok * rstride;
      const int pieces = tok * cpr;
      for (int k = 0; k < (pieces + 31) / 32; ++k) {
        const int p = lane + 32 * k;
        const int t = min(p / cpr, tok - 1);
        const int c = p - t * cpr;
        const int64_t r = __shfl_sync(0xffffffffu, row, t);
        if (p < pieces) {
          const int64_t off = r < 0 ? 0 : r * row_bytes + c * 16;
          cp_async16(kd + t * rstride + c * 16, k_bytes + off, r >= 0);
          cp_async16(vd + t * rstride + c * 16, v_bytes + off, r >= 0);
        }
      }
      if constexpr (kQuant) {
        if (lane < 2 * tok) {  // K scales, then V scales
          const bool is_v = lane >= tok;
          cp_async4(sc_s + (st * 2 + is_v) * tok + (lane & (tok - 1)),
                    (is_v ? v_scale : k_scale) + (row < 0 ? 0 : row),
                    row >= 0);
        }
      }
    }
    cp_async_commit();
  };

  float m[kMaxRows], l[kMaxRows], alpha[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  __syncthreads();  // q_s is written

  issue(0, 0, token_row(0));
  issue(1, 1, token_row(1));
  int64_t ahead = token_row(2);
  for (int i = 0; i < my_chunks; ++i) {
    const int st = i & 1;
    cp_async_wait<1>();
    __syncwarp();  // chunk i landed for every lane
    const int base = t_lo + (warp + i * nwarps) * tok;
    const unsigned char* kd = ring + st * 2 * tok * rstride;
    const unsigned char* vd = kd + tok * rstride;

    // Scores: lane (t_lane, part) over pieces part, part + parts, ...
    float dot[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) dot[r] = 0.f;
    const unsigned char* krow = kd + t_lane * rstride;
    for (int c = part; c < cpr; c += parts) {
      const uint4 raw = *reinterpret_cast<const uint4*>(krow + c * 16);
      const KV* x = reinterpret_cast<const KV*>(&raw);
      float kf[kVec];
      int col0, col1;  // first column of kf[0..15] and of kf[16..31]
      if constexpr (kPacked) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          kf[j] = (float)nibble_lo(x[j]);
          kf[16 + j] = (float)nibble_hi(x[j]);
        }
        col0 = c * 16;
        col1 = col0 + d / 2;
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          if constexpr (kQuant) kf[j] = (float)x[j];
          else kf[j] = to_f32(x[j]);
        }
        col0 = c * kVec;
        col1 = col0;
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < nr) {
          const float* qr = q_s + r * d;
          float acc_r = dot[r];
#pragma unroll
          for (int j4 = 0; j4 < kVec / 4; ++j4) {
            const int col = (kPacked && j4 >= 4) ? col1 + 4 * (j4 - 4)
                                                 : col0 + 4 * j4;
            const float4 qv = *reinterpret_cast<const float4*>(qr + col);
            acc_r = fmaf(qv.x, kf[4 * j4], acc_r);
            acc_r = fmaf(qv.y, kf[4 * j4 + 1], acc_r);
            acc_r = fmaf(qv.z, kf[4 * j4 + 2], acc_r);
            acc_r = fmaf(qv.w, kf[4 * j4 + 3], acc_r);
          }
          dot[r] = acc_r;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      for (int o = tok; o < 32; o <<= 1)
        dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);

    // Online softmax per row over the chunk's tokens.
    const bool valid = base + t_lane < t_hi;
    const float* ksc = sc_s + st * 2 * tok;
    const float k_sc = kQuant ? ksc[t_lane] : 1.f;
    const float v_sc = kQuant ? ksc[tok + t_lane] : 1.f;
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < nr) {
        const float sv = valid ? dot[r] * k_sc * scale : kNegInf;
        float cm = sv;
        for (int o = 1; o < tok; o <<= 1)
          cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, o));
        const float m_new = fmaxf(m[r], cm);
        // Masked entries contribute nothing, even while the row's max is
        // still the mask value.
        const float p = valid ? expf(sv - m_new) : 0.f;
        float ps = p;
        for (int o = 1; o < tok; o <<= 1)
          ps += __shfl_xor_sync(0xffffffffu, ps, o);
        alpha[r] = expf(m[r] - m_new);
        l[r] = l[r] * alpha[r] + ps;
        m[r] = m_new;
        if (part == 0) p_s[r * tok + t_lane] = p * v_sc;
      }
    }
    __syncwarp();

    // acc = acc * alpha + P.V, lanes over 4 columns each.
    const int nt = min(tok, t_hi - base);
    for (int c = lane * 4; c < d; c += 128) {
      float a[kMaxRows][4];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < nr) {
          const float4 x = *reinterpret_cast<const float4*>(acc + r * d + c);
          a[r][0] = x.x * alpha[r];
          a[r][1] = x.y * alpha[r];
          a[r][2] = x.z * alpha[r];
          a[r][3] = x.w * alpha[r];
        }
      }
      for (int t = 0; t < nt; ++t) {
        const unsigned char* vrow = vd + t * rstride;
        float v[4];
        if constexpr (kPacked) {
          const int half = d / 2;
          const bool hi = c >= half;
          const uint32_t w =
              *reinterpret_cast<const uint32_t*>(vrow + (hi ? c - half : c));
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint8_t byte = (w >> (8 * k)) & 0xFF;
            v[k] = (float)(hi ? nibble_hi(byte) : nibble_lo(byte));
          }
        } else if constexpr (kQuant) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(vrow + c);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            v[k] = (float)(int8_t)((w >> (8 * k)) & 0xFF);
        } else if constexpr (std::is_same<KV, float>::value) {
          const float4 x = *reinterpret_cast<const float4*>(vrow + c * 4);
          v[0] = x.x;
          v[1] = x.y;
          v[2] = x.z;
          v[3] = x.w;
        } else {
          const uint2 w = *reinterpret_cast<const uint2*>(vrow + c * 2);
          const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
          const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
          v[0] = __low2float(lo);
          v[1] = __high2float(lo);
          v[2] = __low2float(hi);
          v[3] = __high2float(hi);
        }
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < nr) {
            const float pr = p_s[r * tok + t];
#pragma unroll
            for (int k = 0; k < 4; ++k) a[r][k] = fmaf(pr, v[k], a[r][k]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < nr)
          *reinterpret_cast<float4*>(acc + r * d + c) =
              make_float4(a[r][0], a[r][1], a[r][2], a[r][3]);
      }
    }
    __syncwarp();  // the stage and p_s are free
    const int64_t row = ahead;
    ahead = token_row(i + 3);
    issue(i + 2, st, row);
  }
  cp_async_wait<0>();

  // Merge the warps' states; write the output (NS = 1) or the partial.
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      wm[warp * kMaxRows + r] = m[r];
      wl[warp * kMaxRows + r] = l[r];
    }
  }
  __syncthreads();
  for (int i = tid; i < nr * d; i += blockDim.x) {
    const int r = i / d;
    const int c = i - r * d;
    float mx = kNegInf;
    for (int w = 0; w < nwarps; ++w) mx = fmaxf(mx, wm[w * kMaxRows + r]);
    float sum = 0.f, a = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      const float e = expf(wm[w * kMaxRows + r] - mx);
      sum += wl[w * kMaxRows + r] * e;
      a += reinterpret_cast<const float*>(warps_base + w * wbytes +
                                          acc_off)[r * d + c] * e;
    }
    if (sr.n_active == 1) {  // the one split writes the output itself
      out[(out_row + r) * d + c] = from_f32<T>(a / fmaxf(sum, 1e-20f));
    } else {
      const int64_t prow = (out_row + r) * num_splits + split;
      part_acc[prow * d + c] = a;
      if (c == 0) {
        part_ml[prow * 2] = mx;
        part_ml[prow * 2 + 1] = sum;
      }
    }
  }
  if (sr.n_active > 1)
    finish_split(part_acc, part_ml, out, counters + slot,
                 reinterpret_cast<int*>(smem_raw), out_row, nr, d,
                 num_splits, sr.n_active);
}

// ------------------------------------------------------------------------
// Tensor-core kernel (bf16 q, head dim up to 256): the same split, warps
// and ring, with S = Q.K^T and O += P.V on mma.sync.m16n8k16 (the query
// rows padded to one 16-row M tile) and the online softmax in registers.

constexpr int kMmaRows = 16;  // query rows per block: one mma M tile
constexpr int kMmaWarps = 4;
constexpr int kSub = 16;      // keys per mma step

// Tokens per chunk: 16 for a bf16 pool, 32 for int8 and int4 codes, so a
// stage holds about the same bytes (8 KB at D 128) for every pool kind
// and the quantized pools take half as many chunks per token.
template <typename KV>
__host__ __device__ constexpr int mma_tok() {
  return std::is_same<KV, __nv_bfloat16>::value ? 16 : 32;
}

// Bytes of one warp's region: its ring (bf16 rows of DP + 8 for a float
// pool; codes, scales and a converted 16-key bf16 K/V tile for a
// quantized one), reused for the warp's float32 O [16][DP] at the end.
template <typename KV, int DP>
__host__ __device__ inline size_t mma_warp_smem(int row_bytes) {
  constexpr bool kQuant = !std::is_same<KV, __nv_bfloat16>::value;
  constexpr int T = mma_tok<KV>();
  constexpr size_t S = DP + 8;
  const size_t ring =
      kQuant ? (size_t)kStages * 2 * T * row_bytes +
                   (size_t)kStages * 2 * T * 4 + 2 * kSub * S * 2
             : (size_t)kStages * 2 * T * S * 2;
  const size_t o = (size_t)kMmaRows * DP * 4;
  return ring > o ? ring : o;
}
template <typename KV, int DP>
inline size_t mma_smem(int row_bytes) {
  return (size_t)kMmaRows * (DP + 8) * 2 + 2 * kMmaWarps * kMmaRows * 4 +
         kMmaWarps * mma_warp_smem<KV, DP>(row_bytes);
}

template <typename KV, int DP>
__global__ void __launch_bounds__(32 * kMmaWarps) paged_decode_kernel_mma(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, D]
    const KV* __restrict__ k_pages,       // [P, pg, Hkv, D or D/2]
    const KV* __restrict__ v_pages,       // [P, pg, Hkv, D or D/2]
    const float* __restrict__ k_scale,    // [P, pg, Hkv] or null
    const float* __restrict__ v_scale,    // [P, pg, Hkv] or null
    const int* __restrict__ block_tables, // [B, MP]
    const int* __restrict__ kv_len,       // [B]
    __nv_bfloat16* __restrict__ out,      // [B, Hq, D]
    float* __restrict__ part_acc,         // [B, Hq, NS, D] (NS > 1)
    float* __restrict__ part_ml,          // [B, Hq, NS, 2] (NS > 1)
    int* __restrict__ counters,           // [B, Hkv, row groups] (NS > 1)
    int num_pages, int page_size, int hkv, int n_rep, int d, int max_pages,
    int sliding_window, float scale_log2, int num_splits,
    int pages_per_split) {
  constexpr bool kPacked = std::is_same<KV, uint8_t>::value;
  constexpr bool kQuant = !std::is_same<KV, __nv_bfloat16>::value;
  constexpr int S = DP + 8;  // bf16 smem row stride (ldmatrix conflict-free)
  constexpr int kKB = DP / 16;
  constexpr int kDN = DP / 8;
  constexpr bool kQRegs = DP <= 128;
  constexpr int T = mma_tok<KV>();
  const int R = n_rep;
  const int n_groups = (R + kMmaRows - 1) / kMmaRows;
  // Block order (b, split, group, kv-head), kv-head fastest: the heads of
  // one token range run side by side and read neighbouring bytes of the
  // same pool rows ([P, pg, Hkv, D]).
  int idx = blockIdx.x;
  const int h = idx % hkv;
  idx /= hkv;
  const int grp = idx % n_groups;
  idx /= n_groups;
  const int split = idx % num_splits;
  const int b = idx / num_splits;
  const int64_t slot = ((int64_t)b * n_groups + grp) * hkv + h;
  const int r0 = grp * kMmaRows;
  const int nr = min(kMmaRows, R - r0);
  const int hq = hkv * R;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int row_bytes = kPacked ? d / 2 : d * (int)sizeof(KV);
  const int cpr = row_bytes / 16;  // 16-byte pieces per stored row
  const int64_t out_row = (int64_t)b * hq + h * R + r0;  // first row
  extern __shared__ __align__(16) unsigned char smem_raw[];

  // This split's tokens, read before anything else: a split past the last
  // non-empty one exits at once (split 0 writes zeros when no split holds
  // a token).
  const SplitRange sr = split_range(kv_len[b], split, page_size, max_pages,
                                    sliding_window, pages_per_split);
  if (split >= sr.n_active) {
    if (split == 0)
      for (int i = tid; i < nr * d; i += blockDim.x)
        out[out_row * d + i] = __float2bfloat16(0.f);
    return;
  }
  const int t_lo = sr.t_lo, t_hi = sr.t_hi;
  const int n_chunks = (t_hi - t_lo + T - 1) / T;

  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* wm = reinterpret_cast<float*>(q_s + kMmaRows * S);  // [warps][16]
  float* wl = wm + kMmaWarps * kMmaRows;                     // [warps][16]
  unsigned char* regions = reinterpret_cast<unsigned char*>(
      wl + kMmaWarps * kMmaRows);
  const size_t wbytes = mma_warp_smem<KV, DP>(row_bytes);
  unsigned char* wbase = regions + warp * wbytes;
  // Float pool: ring [st][K,V][T][S] bf16. Quantized: codes
  // [st][K,V][T][row_bytes], scales [st][K,V][T], tile [K,V][16][S] bf16.
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(wbase);
  unsigned char* codes = wbase;
  float* scl = reinterpret_cast<float*>(codes + kStages * 2 * T * row_bytes);
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(scl + kStages * 2 * T);

  const int* bt = block_tables + (int64_t)b * max_pages;
  const int my_chunks =
      n_chunks > warp ? (n_chunks - warp + kMmaWarps - 1) / kMmaWarps : 0;
  // Pool row of token lane % T of this warp's chunk i, or -1 past the
  // range; read one chunk ahead of its copies.
  auto token_row = [&](int i) -> int64_t {
    const int pos = t_lo + (warp + i * kMmaWarps) * T + (lane & (T - 1));
    if (i >= my_chunks || pos >= t_hi) return -1;
    const int page = checked_page(bt, pos / page_size, num_pages);
    return ((int64_t)page * page_size + pos % page_size) * hkv + h;
  };
  const int64_t row0 = token_row(0);
  const int64_t row1 = token_row(1);

  // Q rows (bf16; zero past nr rows and d columns) and the zero head-dim
  // padding of the warp's bf16 K/V rows (copies and conversions write only
  // columns < d), while the block-table reads are in flight.
  for (int i = tid; i < kMmaRows * DP; i += blockDim.x) {
    const int r = i / DP;
    const int c = i - r * DP;
    q_s[r * S + c] = (r < nr && c < d) ? q[(out_row + r) * d + c]
                                       : __float2bfloat16(0.f);
  }
  if (d < DP) {
    __nv_bfloat16* buf = kQuant ? tile : ring;
    const int rows = kQuant ? 2 * kSub : kStages * 2 * T;
    const int pad = DP - d;
    for (int i = lane; i < rows * pad; i += 32) {
      const int row = i / pad;
      buf[row * S + d + (i - row * pad)] = __float2bfloat16(0.f);
    }
  }

  const unsigned char* k_bytes = reinterpret_cast<const unsigned char*>(k_pages);
  const unsigned char* v_bytes = reinterpret_cast<const unsigned char*>(v_pages);
  // Copy chunk i into stage st: piece p = lane + 32 k is 16 bytes of
  // token p / cpr, whose row comes from that token's lane by a shuffle.
  auto issue = [&](int i, int st, int64_t row) {
    if (i < my_chunks) {
      const int pieces = T * cpr;
      const int dt = 32 / cpr, dc = 32 % cpr;
      int t = lane / cpr, c = lane % cpr;
      for (int p = lane; p < ((pieces + 31) & ~31); p += 32) {
        const int64_t r = __shfl_sync(0xffffffffu, row, min(t, T - 1));
        if (p < pieces) {
          const int64_t off = r < 0 ? 0 : r * row_bytes + c * 16;
          if constexpr (kQuant) {
            unsigned char* dk = codes + ((st * 2) * T + t) * row_bytes + c * 16;
            cp_async16(dk, k_bytes + off, r >= 0);
            cp_async16(dk + T * row_bytes, v_bytes + off, r >= 0);
          } else {
            __nv_bfloat16* dk = ring + ((st * 2) * T + t) * S + c * 8;
            cp_async16(dk, k_bytes + off, r >= 0);
            cp_async16(dk + T * S, v_bytes + off, r >= 0);
          }
        }
        t += dt;
        c += dc;
        if (c >= cpr) {
          c -= cpr;
          ++t;
        }
      }
      if constexpr (kQuant) {  // lane t: token t's K and V scales
        const int64_t r = row < 0 ? 0 : row;
        cp_async4(scl + (st * 2) * T + lane, k_scale + r, row >= 0);
        cp_async4(scl + (st * 2 + 1) * T + lane, v_scale + r, row >= 0);
      }
    }
    cp_async_commit();
  };

  issue(0, 0, row0);
  issue(1, 1, row1);
  int64_t ahead = token_row(2);
  __syncthreads();  // q_s is written
  uint32_t qa[kQRegs ? kKB : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kb = 0; kb < (kQRegs ? kKB : 1); ++kb)
      ldmatrix_x4(qa[kb], q_s + (lane & 15) * S + kb * 16 + (lane >> 4) * 8);
  }
  float o[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share; quad-reduced at the end

  for (int i = 0; i < my_chunks; ++i) {
    const int st = i & 1;
    cp_async_wait<1>();
    __syncwarp();  // chunk i landed for every lane
    const int base = t_lo + (warp + i * kMmaWarps) * T;
    const float* ksc = scl + st * 2 * T;  // [K,V][T] (quantized pools)
    for (int sub = 0; sub < T / kSub && base + sub * kSub < t_hi; ++sub) {
      const __nv_bfloat16* kt;
      if constexpr (kQuant) {
        // This step's 16 keys' codes to bf16: K exactly (|code| <= 128),
        // its scale multiplying the score; V times its scale in float32,
        // rounded once.
        for (int p = lane; p < 2 * kSub * cpr; p += 32) {
          const int row = p / cpr;  // 16 K rows, then 16 V rows
          const int c = p - row * cpr;
          const int src = (row < kSub ? row : T + row - kSub) + sub * kSub;
          const uint4 raw = *reinterpret_cast<const uint4*>(
              codes + (st * 2 * T + src) * row_bytes + c * 16);
          __nv_bfloat16* dst = tile + row * S;
          uint32_t lo[8], hi[8];
          if (row < kSub)
            codes_to_bf16<kPacked>(raw, lo, hi);
          else
            codes_to_bf16_scaled<kPacked>(raw, ksc[src], lo, hi);
          if constexpr (kPacked) {
            uint4* z = reinterpret_cast<uint4*>(dst + c * 16 + d / 2);
            z[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
            z[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
          }
          uint4* a = reinterpret_cast<uint4*>(dst + c * 16);
          a[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
          a[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
        }
        __syncwarp();
        kt = tile;
      } else {
        kt = ring + st * 2 * T * S;
      }
      const __nv_bfloat16* vt = kt + (kQuant ? kSub : T) * S;

      // S = Q.K^T: 16 rows x 16 keys (two n-blocks).
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kb = 0; kb < kKB; ++kb) {
        uint32_t a[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int j = 0; j < 4; ++j) a[j] = qa[kQRegs ? kb : 0][j];
        } else {
          ldmatrix_x4(a, q_s + (lane & 15) * S + kb * 16 + (lane >> 4) * 8);
        }
        uint32_t bb[4];
        ldmatrix_x4(bb, kt + ((lane & 7) + ((lane >> 4) << 3)) * S +
                            kb * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[0], a, bb[0], bb[1]);
        mma_bf16(s[1], a, bb[2], bb[3]);
      }

      // Scale (log2 domain, times the key's scale), mask past the range,
      // online softmax for this thread's rows g and g + 8.
      const int key0 = sub * kSub;  // this step's first key in the chunk
      float alpha[2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + n * 8 + 2 * tq + (e & 1);
          const float x = s[n][e] * scale_log2 * (kQuant ? ksc[key] : 1.f);
          s[n][e] = base + key < t_hi ? x : kNegInf;
        }
      }
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        float mx = fmaxf(fmaxf(s[0][2 * i2], s[0][2 * i2 + 1]),
                         fmaxf(s[1][2 * i2], s[1][2 * i2 + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i2], mx);
        alpha[i2] = exp2f(m[i2] - m_new);
        m[i2] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 2 * i2; e < 2 * i2 + 2; ++e) {
            // Masked entries contribute nothing, even while the row's max
            // is still the mask value.
            const float p =
                s[n][e] > 0.5f * kNegInf ? exp2f(s[n][e] - m_new) : 0.f;
            sum += p;
            s[n][e] = p;
          }
        }
        l[i2] = l[i2] * alpha[i2] + sum;
      }
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < kDN; ++n) {
          o[n][0] *= alpha[0];
          o[n][1] *= alpha[0];
          o[n][2] *= alpha[1];
          o[n][3] *= alpha[1];
        }
      }

      // O += P.V: P (bf16) from registers is the A operand.
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int dn = 0; dn < DP / 16; ++dn) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * S +
                                  dn * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dn], pa, bb[0], bb[1]);
        mma_bf16(o[2 * dn + 1], pa, bb[2], bb[3]);
      }
      __syncwarp();  // the tile is free for the next step
    }
    const int64_t row = ahead;  // the stage is free: chunk i + 2 into it
    ahead = token_row(i + 3);
    issue(i + 2, st, row);
  }
  cp_async_wait<0>();
  __syncwarp();

  // The warp's state to shared memory (O over its own region), then the
  // block merges the warps: the output (NS = 1) or the partial.
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    l[i2] += __shfl_xor_sync(0xffffffffu, l[i2], 1);
    l[i2] += __shfl_xor_sync(0xffffffffu, l[i2], 2);
    if (tq == 0) {
      wm[warp * kMmaRows + g + 8 * i2] = m[i2];
      wl[warp * kMmaRows + g + 8 * i2] = l[i2];
    }
  }
  float* o_s = reinterpret_cast<float*>(wbase);  // [16][DP]
#pragma unroll
  for (int n = 0; n < kDN; ++n) {
    const int col = n * 8 + 2 * tq;
    *reinterpret_cast<float2*>(o_s + g * DP + col) =
        make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(o_s + (g + 8) * DP + col) =
        make_float2(o[n][2], o[n][3]);
  }
  __syncthreads();
  for (int i = tid; i < nr * d; i += blockDim.x) {
    const int r = i / d;
    const int c = i - r * d;
    float mx = kNegInf;
    for (int w = 0; w < kMmaWarps; ++w)
      mx = fmaxf(mx, wm[w * kMmaRows + r]);
    float sum = 0.f, a = 0.f;
    for (int w = 0; w < kMmaWarps; ++w) {
      const float e = exp2f(wm[w * kMmaRows + r] - mx);
      sum += wl[w * kMmaRows + r] * e;
      a += reinterpret_cast<const float*>(regions + w * wbytes)[r * DP + c] *
           e;
    }
    if (sr.n_active == 1) {  // the one split writes the output itself
      out[(out_row + r) * d + c] = __float2bfloat16(a / fmaxf(sum, 1e-20f));
    } else {
      // Partials carry m in the natural-log domain, as the CUDA-core
      // kernel's, for the shared finish_split.
      const int64_t prow = (out_row + r) * num_splits + split;
      part_acc[prow * d + c] = a;
      if (c == 0) {
        part_ml[prow * 2] = mx > 0.5f * kNegInf ? mx * 0.6931471805599453f
                                                : kNegInf;
        part_ml[prow * 2 + 1] = sum;
      }
    }
  }
  if (sr.n_active > 1)
    finish_split(part_acc, part_ml, out, counters + slot,
                 reinterpret_cast<int*>(smem_raw), out_row, nr, d,
                 num_splits, sr.n_active);
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *bt, *kv_len;
  void *out, *part_acc, *part_ml, *counters;
  int batch, hq, hkv, d, num_pages, page_size, max_pages, sliding_window;
  float scale;
  int num_splits, pages_per_split;
  cudaStream_t stream;
};

// (tokens per chunk, warps per block), first that fits shared memory.
constexpr int kShapes[][2] = {{16, 4}, {16, 2}, {8, 2}, {16, 1},
                              {8, 1},  {4, 1},  {2, 1}, {1, 1}};

template <typename T, typename KV>
cudaError_t launch(const Args& a) {
  if (a.num_splits < 1 || a.pages_per_split < 1) return cudaErrorInvalidValue;
  if (a.num_splits > 1 && (a.part_acc == nullptr || a.part_ml == nullptr ||
                           a.counters == nullptr))
    return cudaErrorInvalidValue;
  const int n_rep = a.hq / a.hkv;
  const int n_groups = (n_rep + kMaxRows - 1) / kMaxRows;
  const int acc_rows = min(n_rep, kMaxRows);
  const int row_bytes = std::is_same<KV, uint8_t>::value
                            ? a.d / 2 : a.d * (int)sizeof(KV);
  int tok = 0, warps = 0;
  size_t smem = 0;
  for (const auto& s : kShapes) {
    smem = decode_smem(s[0], s[1], row_bytes, acc_rows, a.d);
    if (smem <= kMaxSmem) {
      tok = s[0];
      warps = s[1];
      break;
    }
  }
  if (tok == 0) return cudaErrorInvalidValue;
  cudaError_t err = prepare_smem(paged_decode_kernel<T, KV>, smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks =
      (int64_t)a.batch * a.hkv * n_groups * a.num_splits;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  paged_decode_kernel<T, KV><<<(unsigned)blocks, 32 * warps, smem,
                               a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.kv_len), static_cast<T*>(a.out),
      static_cast<float*>(a.part_acc), static_cast<float*>(a.part_ml),
      static_cast<int*>(a.counters),
      a.num_pages, a.page_size, a.hkv, n_rep, a.d, a.max_pages,
      a.sliding_window, a.scale, a.num_splits, a.pages_per_split, tok);
  return cudaGetLastError();
}

template <typename KV, int DP>
cudaError_t launch_mma(const Args& a) {
  if (a.num_splits < 1 || a.pages_per_split < 1) return cudaErrorInvalidValue;
  if (a.num_splits > 1 && (a.part_acc == nullptr || a.part_ml == nullptr ||
                           a.counters == nullptr))
    return cudaErrorInvalidValue;
  const int n_rep = a.hq / a.hkv;
  const int n_groups = (n_rep + kMmaRows - 1) / kMmaRows;
  const int row_bytes = std::is_same<KV, uint8_t>::value
                            ? a.d / 2 : a.d * (int)sizeof(KV);
  const size_t smem = mma_smem<KV, DP>(row_bytes);
  cudaError_t err = prepare_smem(paged_decode_kernel_mma<KV, DP>, smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks =
      (int64_t)a.batch * a.hkv * n_groups * a.num_splits;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  paged_decode_kernel_mma<KV, DP><<<(unsigned)blocks, 32 * kMmaWarps, smem,
                                    a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.kv_len), static_cast<__nv_bfloat16*>(a.out),
      static_cast<float*>(a.part_acc), static_cast<float*>(a.part_ml),
      static_cast<int*>(a.counters),
      a.num_pages, a.page_size, a.hkv, n_rep, a.d, a.max_pages,
      a.sliding_window, a.scale * 1.4426950408889634f, a.num_splits,
      a.pages_per_split);
  return cudaGetLastError();
}

// bf16 q: the tensor-core kernel at the smallest padded head dim that
// holds d, the CUDA-core kernel above 256.
template <typename KV>
cudaError_t launch_bf16(const Args& a) {
  if (a.d <= 64) return launch_mma<KV, 64>(a);
  if (a.d <= 128) return launch_mma<KV, 128>(a);
  if (a.d <= 256) return launch_mma<KV, 256>(a);
  return launch<__nv_bfloat16, KV>(a);
}

cudaError_t launch_kind(int dtype, int kv_kind, const Args& a) {
  if (kv_kind != kKvFloat &&
      ((a.k_scale == nullptr) || (a.v_scale == nullptr)))
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (kv_kind == kKvFloat) return launch<float, float>(a);
    if (kv_kind == kKvInt8) return launch<float, int8_t>(a);
    if (kv_kind == kKvInt4) return launch<float, uint8_t>(a);
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
// uint8, both with float32 scales. num_splits / pages_per_split: the
// host's split plan; with num_splits > 1, part_acc ([B, Hq, NS, D]) and
// part_ml ([B, Hq, NS, 2]) are float32 scratch, and counters holds
// B * Hkv * ceil(n_rep / 8) int32 zeros, which every launch leaves zero.
// Returns a cudaError_t (0 = launched).
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* kv_len, void* out, void* part_acc, void* part_ml,
    void* counters, int dtype,
    int kv_kind, int batch, int hq, int hkv, int d, int num_pages,
    int page_size, int max_pages, int sliding_window, float scale,
    int num_splits, int pages_per_split, void* stream) {
  const tpuinf::Args a{q, k_pages, v_pages, k_scale, v_scale,
                       block_tables, kv_len, out, part_acc, part_ml,
                       counters,
                       batch, hq, hkv, d, num_pages, page_size, max_pages,
                       sliding_window, scale, num_splits, pages_per_split,
                       static_cast<cudaStream_t>(stream)};
  return tpuinf::launch_kind(dtype, kv_kind, a);
}
