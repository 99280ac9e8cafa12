// Causal GQA flash-attention forward in bfloat16 on Hopper's tensor cores
// (sm_90a): mma.sync m16n8k16 with float32 sums, K/V tiles staged in
// shared memory by cp.async, two stages.
//
// Replaces the Pallas kernel repro/kernels/flash_attention/kernel.py
// (`flash_attention_fwd`, body `_kernel`) for bfloat16 inputs; float32
// inputs take csrc/flash_attention.cu. For every query row of every query
// head it computes, in float32:
//   s_j = (q . k_j) * (1/sqrt(hd)): the product on the tensor cores from
//         the bf16 operands, the scale multiplied after it (not folded into
//         q), masked to -1e30 where the key is after the query (causal),
//         `window` or more positions before it (window > 0), or at or
//         beyond kv_len;
//   per chunk of `chunk` keys (from key 0): m_new = max(m, max_j s_j);
//         corr = expf(m - m_new); p_j = expf(s_j - m_new) (expf, not exp2f
//         with log2(e) folded in, so that p rounds as torch.exp's does);
//         l = l*corr + sum_j p_j over the unrounded float32 p;
//         acc = acc*corr + sum_j bf16(p_j) v_j;
//   out = acc / max(l, 1e-30), written in bfloat16.
// That is the model's blocked flash attention (repro/models/attention.py:
// 120-141) and this package's flash_attention_plain: p is rounded to V's
// type before the PV product, and the running max is refreshed once per
// chunk of the model's chunk_kv keys (1024 by default), not once per tile,
// since which max p is rounded against decides the rounding (a per-tile max
// moved the bf16 serve's prefill logits past 3e-2 of their scale). Nothing
// is padded: keys at or beyond Skv are never read (their shared-memory rows
// are zero-filled) and key tiles wholly masked for a warp's rows are not
// multiplied, since their p is exactly 0.
//
// Window: key j is seen by query i (at position q_offset + i) iff j <= i
// (causal), i - j < window and j < kv_len, the mask of the model's flash
// attention (repro/models/attention.py:144-147). A block starts its key
// loop at the tile that holds its first query's first key in the window;
// the tiles before it are not staged. That gives the same output: a row's
// own key is always in its window, so every row meets an unmasked key at
// or after every tile skipped for it, and the chunk that holds that key
// either refreshes the max to a real score (a skipped chunk before it
// would have been scaled away by corr = exp(-1e30 - m) = 0 exactly) or
// already had one (a skipped tile inside it would add p = 0 exactly). A
// row whose window holds no key below kv_len is undefined (the plain
// version gives a mean of masked values there, the kernel zeros).
//
// Chunk max: two passes over each chunk's key tiles. The first multiplies
// Q K^T and keeps each row's largest unmasked product, scaled once at the
// chunk's end (scale > 0 and rounding is monotonic, so that is the max of
// the scaled scores, one multiply per row instead of one per score); the
// second multiplies the same tiles in the same mma order, so it recomputes
// every score bit for bit, and goes on to p and P V. That costs one more
// Q K^T per key (+50% tensor-core work) but holds no scores beyond one
// tile in registers; keeping a whole 1024-key chunk of float32 scores in
// shared memory instead would allow at most 32 rows per block (128 KB)
// and give up the G-head sharing of K/V.
//
// Layouts (row-major, contiguous, 16-byte aligned): q, o (B, Sq, H, hd);
// k, v (B, Skv, K, hd); H = K * G, query head h = kv head h / G, group
// h % G. hd is any multiple of 8 from 8 to 256 (a 16-byte row of bf16 is
// the cp.async unit). The kernel is instantiated for the padded width HDP,
// hd rounded up to a multiple of 16 (the mma k-dimension of Q K^T): Q's
// fragments and the staged K and V rows hold zeros in the columns from hd
// to HDP, which add nothing to a score, and the P V columns from hd on are
// not written. A staged row is HDP / 8 chunks of 16 bytes in a row of
// `row_chunks(HDP)` chunk slots (2, 4, or a multiple of 8), so that the
// XOR swizzle below stays inside the row.
//
// Design: the rows of (query, group) pairs of one kv head, all Sq * G of
// them in query-major order, are cut into tiles of 64 rows; a block of 4
// warps takes one row tile of one (batch row, kv head), 16 rows (one mma
// m-tile) a warp, so the G query heads of a kv head share every K/V tile
// (G = 7 and ragged Sq leave tail rows, which read zeros and are not
// written). Each warp keeps its Q rows as mma A fragments in registers for
// the whole launch. Key tiles of 64 keys are staged as bf16 (K, and V in
// the second pass) by cp.async, 16 bytes a thread, in a ring of two
// stages, so that the next tile loads while this one is multiplied; rows
// are swizzled by 16-byte chunk so that ldmatrix reads them without bank
// conflicts. S = Q K^T takes K's rows as the mma's column-major B operand
// (ldmatrix); P V takes V through ldmatrix.trans, and P goes from the S
// accumulator straight into A fragments, rounded to bf16 in registers
// (that conversion is the model's rounding of p). Row max and row sum are
// reduced across the four threads of an mma row quad by shuffles; no
// atomics, so a launch is deterministic. The causal work of a row tile
// grows with its index, so the grid launches the last row tiles first.
//
// What bounds it: one launch must read Q, K, V and write O once, and does
// 4 * B * H * hd * (causal pairs) operations. On the serving path (hd = 64,
// B = 2, S = 128-1024) the bytes bound it up to S = 512 and the bf16
// tensor-core rate at 1024, both at a few microseconds. The kernel is held
// back by the instructions it spends per score, not by data movement: each
// score costs a dozen float32 instructions in the second pass (scale, mask
// on diagonal tiles, subtract, expf, sum, bf16 pack) against 1/16 of an
// mma, and the first pass repeats Q K^T. Two m-tiles a warp (128 rows a
// block), which halve the shared-memory and L2 reads per mma, were no
// faster at S = 1024 on the card and used every register; taking the
// first pass's max on the unscaled products (one multiply per row, not per
// score) was faster (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;   // (query, group) rows per block
constexpr int BKV = 64;            // keys per staged tile
constexpr int NT = BKV / 8;        // mma n-tiles of a tile's scores
constexpr float NEG_INF = -1e30f;

// argument errors, returned as negative codes
constexpr int ERR_SHAPE = -1;
constexpr int ERR_HEAD_DIM = -2;
constexpr int ERR_GROUP = -3;
constexpr int ERR_KV_LEN = -4;
constexpr int ERR_ALIGN = -5;
constexpr int MAX_HD = 256;

// 16-byte chunk slots of a staged row of HDP bf16: HDP / 8 when that is 2
// or 4, else HDP / 8 rounded up to a multiple of 8 (the swizzle's span)
__host__ __device__ constexpr int row_chunks(int hdp) {
  return hdp / 8 <= 4 ? hdp / 8 : (hdp / 8 + 7) / 8 * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of key row j in a staged tile of
// row_chunks(HD) chunk slots a row: chunks are XOR-swizzled by row so that
// the eight rows one ldmatrix phase reads at the same chunk fall on
// distinct banks
template <int HD>
__device__ __forceinline__ uint32_t chunk_at(int j, int c) {
  constexpr int CH = row_chunks(HD);
  if constexpr (CH >= 8) {
    return static_cast<uint32_t>(j * CH + (c ^ (j & 7))) * 16u;
  } else {
    return static_cast<uint32_t>(j * CH + (c ^ ((j / (8 / CH)) & (CH - 1))))
           * 16u;
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  // src-size 0 reads nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr) : "memory");
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// stage key rows [t0, t0 + BKV) of one head into `dst`; rows at or beyond
// `t_end`, and the chunks at or beyond `hd_chunks` (hd / 8), are
// zero-filled and not read
template <int HD>
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* base,
                                           size_t stride, int t0, int t_end,
                                           int hd_chunks, uint32_t dst) {
  constexpr int CH = HD / 8;
  static_assert(BKV * CH % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < BKV * CH / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int j = e / CH, c = e % CH, kp = t0 + j;
    const bool in = kp < t_end && c < hd_chunks;
    const __nv_bfloat16* src = base + (in ? kp : 0) * stride + c * 8;
    cp_async16(dst + chunk_at<HD>(j, c), src, in);
  }
}

// s = Q K^T for this warp's 16 rows and the staged tile's 64 keys, in a
// fixed mma order (so two calls on one tile agree bit for bit)
template <int HD>
__device__ __forceinline__ void qk_tile(const uint32_t (&qa)[HD / 16][4],
                                        uint32_t ks, int lane,
                                        float (&s)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      // matrices: keys of n-tile n / n+1 (rows), d chunk 2kk / 2kk+1
      uint32_t b0, b1, b2, b3;
      ldsm_x4(ks + chunk_at<HD>((n + (mi >> 1)) * 8 + (lane & 7),
                                2 * kk + (mi & 1)), b0, b1, b2, b3);
      mma_bf16(s[n], qa[kk], b0, b1);
      mma_bf16(s[n + 1], qa[kk], b2, b3);
    }
  }
}

// o += bf16(p) V for the staged tile; p is the score fragment after expf
template <int HD>
__device__ __forceinline__ void pv_tile(const float (&p)[NT][4], uint32_t vs,
                                        int lane, float (&o)[HD / 8][4]) {
  const int mi = lane >> 3;
#pragma unroll
  for (int j = 0; j < BKV / 16; ++j) {
    const uint32_t pa[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                            pack_bf16(p[2 * j][2], p[2 * j][3]),
                            pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                            pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) {
      // matrices (transposed): keys 16j / 16j+8 (rows), d chunk n / n+1
      uint32_t b0, b1, b2, b3;
      ldsm_x4_trans(vs + chunk_at<HD>(16 * j + (mi & 1) * 8 + (lane & 7),
                                      n + (mi >> 1)), b0, b1, b2, b3);
      mma_bf16(o[n], pa, b0, b1);
      mma_bf16(o[n + 1], pa, b2, b3);
    }
  }
}

// where the key loop stands: chunk [c0, c_end), pass 1 or 2, tile at t0.
// A windowed block's first chunk starts at its first tile in the window
// (the chunk's keys before it are masked for every row of the block, so
// they would not move its max); c_end is the chunk's real end, or n_keys.
struct Cursor {
  int c0, c_end, t0;
  bool second;
};

__device__ __forceinline__ void advance(Cursor& c, int n_keys, int chunk) {
  c.t0 += BKV;
  if (c.t0 < c.c_end) return;
  if (!c.second) {
    c.second = true;
    c.t0 = c.c0;
    return;
  }
  c.second = false;
  c.c0 = c.c_end;
  c.c_end = c.c0 + min(chunk, n_keys - c.c0);
  c.t0 = c.c0;
}

// Two instantiations per padded width HD up to 128: GENERAL = false for
// hd == HD and no window, where the width is a constant and the window's
// tests vanish (the dense family's serves, which a runtime width and
// window slowed by ~15% at S = 1024); GENERAL = true for a padded hd
// (hd_arg < HD) or a window, and for every launch at HD > 128
template <int HD, bool GENERAL>
__global__ void __launch_bounds__(THREADS)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o, int B, int Sq,
                          int Skv, int H, int K, int hd_arg, int q_offset,
                          int kv_len, int causal, int window, int chunk,
                          int n_tiles, float scale) {
  constexpr int TILE_BYTES = BKV * row_chunks(HD) * 16;
  const int hd = GENERAL ? hd_arg : HD;
  const bool win = GENERAL && window > 0;
  const int hd_chunks = hd / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_u32(smem);

  const int G = H / K;
  int id = blockIdx.x;
  const int kh = id % K;
  id /= K;
  const int b = id % B;
  const int tile = n_tiles - 1 - id / B;    // heaviest row tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_rows = Sq * G;

  // this thread's two rows (mma rows lane/4 and lane/4 + 8 of its warp)
  const int w0 = tile * ROWS + warp * 16;
  int qpos[2];
  bool active[2];
  size_t row_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w0 + (lane >> 2) + 8 * i;
    const int qi = r / G, g = r - qi * G;
    active[i] = r < n_rows;
    qpos[i] = q_offset + qi;
    row_off[i] = ((static_cast<size_t>(b) * Sq + qi) * H + kh * G + g) * hd;
  }
  // keys the block needs (causal: up to its last query), and the query
  // span of this warp's live rows, for skipping and masking tiles
  const int last_row = min(tile * ROWS + ROWS, n_rows) - 1;
  const int n_keys =
      causal ? min(kv_len, q_offset + last_row / G + 1) : kv_len;
  const bool warp_live = w0 < n_rows;
  const int wq_first = q_offset + w0 / G;
  const int wq_last = q_offset + (min(w0 + 15, n_rows - 1)) / G;
  // with a window: the first key any row of the block sees, and the first
  // key any row of the warp sees
  const int block_lo =
      win ? max(0, q_offset + tile * ROWS / G - window + 1) : 0;
  const int warp_lo = win ? wq_first - window + 1 : 0;

  // Q's fragments, zero in the padded columns hd..HD
  uint32_t qa[HD / 16][4];
  {
    const int c = (lane & 3) * 2;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const bool lo = 16 * kk < hd, hi8 = 16 * kk + 8 < hd;
      qa[kk][0] = active[0] && lo ? load_u32(q + row_off[0] + 16 * kk + c)
                                  : 0u;
      qa[kk][1] = active[1] && lo ? load_u32(q + row_off[1] + 16 * kk + c)
                                  : 0u;
      qa[kk][2] = active[0] && hi8
                      ? load_u32(q + row_off[0] + 16 * kk + c + 8) : 0u;
      qa[kk][3] = active[1] && hi8
                      ? load_u32(q + row_off[1] + 16 * kk + c + 8) : 0u;
    }
  }

  const size_t kv_stride = static_cast<size_t>(K) * hd;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * Skv * kv_stride
                            + kh * hd;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * Skv * kv_stride
                            + kh * hd;

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  // per row: running max m, row sum l, and in the first pass the chunk's
  // largest unscaled score (scaling by scale > 0 keeps the order, and
  // rounding is monotonic, so max_j fl(s_j * scale) = fl(max_j s_j * scale))
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float raw_max[2] = {-INFINITY, -INFINITY};

  // the chunk that holds block_lo, from its tile that holds block_lo
  const int c_first = block_lo / chunk * chunk;
  const int t_first = c_first + (block_lo - c_first) / BKV * BKV;
  Cursor cur{t_first, c_first + min(chunk, n_keys - c_first), t_first,
             false};
  // stage 0 <- the first tile (pass 1 reads K only)
  stage_tile<HD>(kb, kv_stride, cur.t0, cur.c_end, hd_chunks, sbase);
  cp_async_commit();
  int stage = 0;
  while (cur.c0 < n_keys) {
    Cursor nxt = cur;
    advance(nxt, n_keys, chunk);
    if (nxt.c0 < n_keys) {
      const uint32_t dst = sbase + (stage ^ 1) * 2 * TILE_BYTES;
      stage_tile<HD>(kb, kv_stride, nxt.t0, nxt.c_end, hd_chunks, dst);
      if (nxt.second)
        stage_tile<HD>(vb, kv_stride, nxt.t0, nxt.c_end, hd_chunks,
                       dst + TILE_BYTES);
    }
    cp_async_commit();
    cp_async_wait_one();     // this tile's copies are done (this thread's)
    __syncthreads();         // ... and every thread's

    const int t0 = cur.t0;
    // keys at or beyond hi belong to a later chunk, lie past kv_len, or
    // (causal) come after every query of the block
    const int hi = cur.c_end;
    if (warp_live && !(causal && t0 > wq_last)
        && (!win || t0 + BKV > warp_lo)) {
      const uint32_t ks = sbase + stage * 2 * TILE_BYTES;
      float s[NT][4];
      qk_tile<HD>(qa, ks, lane, s);
      const bool masked = t0 + BKV > hi || (causal && t0 + BKV - 1 > wq_first)
                          || (win && t0 <= wq_last - window);
      // one loop per pass, each with the pass's branch outside it
      if (!cur.second) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            bool keep = true;
            if (masked) {
              const int kp = t0 + n * 8 + (lane & 3) * 2 + (e & 1);
              keep = kp < hi && (!causal || kp <= qpos[e >> 1])
                     && (!win || qpos[e >> 1] - kp < window);
            }
            if (keep) raw_max[e >> 1] = fmaxf(raw_max[e >> 1], s[n][e]);
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[n][e] * scale;
            if (masked) {
              const int kp = t0 + n * 8 + (lane & 3) * 2 + (e & 1);
              const bool keep = kp < hi && (!causal || kp <= qpos[e >> 1])
                                && (!win || qpos[e >> 1] - kp < window);
              x = keep ? x : NEG_INF;
            }
            const float p = expf(x - m[e >> 1]);
            l[e >> 1] += p;
            s[n][e] = p;
          }
        }
        pv_tile<HD>(s, ks + TILE_BYTES, lane, acc);
      }
    }
    if (!cur.second && cur.t0 + BKV >= cur.c_end) {
      // end of pass 1: the chunk's max m_new = max(m, max_j s_j), the same
      // in the row's four threads; a row with no key in the chunk keeps m
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float r = raw_max[i];
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
        const float m_new = fmaxf(m[i], r * scale);
        corr[i] = expf(m[i] - m_new);
        l[i] *= corr[i];
        m[i] = m_new;
        raw_max[i] = -INFINITY;
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
    }
    __syncthreads();         // the stage is free for the next copies
    cur = nxt;
    stage ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  const int c = (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (n * 8 >= hd) break;        // padded columns
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!active[i]) continue;
      *reinterpret_cast<uint32_t*>(o + row_off[i] + n * 8 + c) =
          pack_bf16(acc[n][2 * i] / l[i], acc[n][2 * i + 1] / l[i]);
    }
  }
}

template <int HD>
int launch_hd(int B, int Sq, int Skv, int H, int K, int hd, int q_offset,
              int kv_len, int causal, int window, int chunk, const void* q,
              const void* k, const void* v, void* o, cudaStream_t stream) {
  // two stages of K and V
  constexpr int SMEM = 2 * 2 * BKV * row_chunks(HD) * 16;
  constexpr bool FAST = HD <= 128;    // has a GENERAL = false instance
  const bool general = !FAST || hd != HD || window > 0;
  auto kernel = flash_attention_tc_kernel<HD, true>;
  if constexpr (FAST) {
    if (!general) kernel = flash_attention_tc_kernel<HD, false>;
  }
  if constexpr (SMEM > 48 * 1024) {   // HD >= 80: 64 to 128 KB
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int G = H / K;
  const int n_tiles = (Sq * G + ROWS - 1) / ROWS;
  // 1/sqrt(hd) rounded once to float32, as the reference's float64 scale
  const float scale =
      static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  kernel<<<n_tiles * B * K, THREADS, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      B, Sq, Skv, H, K, hd, q_offset, kv_len, causal, window, chunk, n_tiles,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation for the padded width HDP = hd rounded up to 16
template <int HD>
int launch_padded(int hdp, int B, int Sq, int Skv, int H, int K, int hd,
                  int q_offset, int kv_len, int causal, int window, int chunk,
                  const void* q, const void* k, const void* v, void* o,
                  cudaStream_t stream) {
  if (hdp == HD)
    return launch_hd<HD>(B, Sq, Skv, H, K, hd, q_offset, kv_len, causal,
                         window, chunk, q, k, v, o, stream);
  if constexpr (HD < MAX_HD)
    return launch_padded<HD + 16>(hdp, B, Sq, Skv, H, K, hd, q_offset,
                                  kv_len, causal, window, chunk, q, k, v, o,
                                  stream);
  return ERR_HEAD_DIM;
}

}  // namespace

extern "C" {

// q, k, v, o bfloat16, contiguous, 16-byte aligned. window: 0 for none,
// else keys at or beyond window positions before the query are masked.
// chunk: keys per max refresh (>= 1; the model's chunk_kv).
// Returns 0, a negative argument error, or the cudaError_t of the launch.
int flash_attention_tc_launch(int B, int Sq, int Skv, int H, int K, int hd,
                              int q_offset, int kv_len, int causal,
                              int window, int chunk, const void* q,
                              const void* k, const void* v, void* o,
                              void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || K < 1 || H < K || q_offset < 0 ||
      chunk < 1 || window < 0)
    return ERR_SHAPE;
  if (H % K != 0) return ERR_GROUP;
  if (kv_len < 1 || kv_len > Skv) return ERR_KV_LEN;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return ERR_ALIGN;
  if (hd < 8 || hd > MAX_HD || hd % 8 != 0) return ERR_HEAD_DIM;
  return launch_padded<16>((hd + 15) / 16 * 16, B, Sq, Skv, H, K, hd,
                           q_offset, kv_len, causal, window, chunk, q, k, v,
                           o, static_cast<cudaStream_t>(stream));
}

const char* flash_attention_tc_error(int code) {
  switch (code) {
    case ERR_SHAPE:
      return "need B, Sq, Skv, K, chunk >= 1, H >= K, q_offset >= 0 and "
             "window >= 0";
    case ERR_HEAD_DIM: return "head_dim must be a multiple of 8 in 8..256";
    case ERR_GROUP: return "H must be a multiple of K";
    case ERR_KV_LEN: return "kv_len must lie in 1..Skv";
    case ERR_ALIGN: return "q, k, v and out must be 16-byte aligned";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
