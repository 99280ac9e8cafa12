// Causal GQA flash-attention forward in float32 for sm_90a: online softmax
// over key tiles on the float32 CUDA cores, register-tiled Q K^T and P V.
//
// Replaces the Pallas kernel repro/kernels/flash_attention/kernel.py
// (`flash_attention_fwd`, body `_kernel`) for float32 inputs; bfloat16
// inputs take the tensor-core kernel csrc/flash_attention_tc.cu. It runs
// on the float32 CUDA cores and not in TF32, which would break the
// reference's float32 contract (2e-5). For every query row of every query
// head it computes, in float32:
//   s_j = (q . k_j) * (1/sqrt(hd)), masked to -1e30 where the key is after
//         the query (causal), `window` or more positions before it
//         (window > 0), or at or beyond kv_len;
//   per key tile of BKV = 64 keys (from key 0): m_new = max(m, max_j s_j);
//         corr = expf(m - m_new); p_j = expf(s_j - m_new);
//         l = l*corr + sum_j p_j; acc = acc*corr + sum_j p_j v_j;
//   out = acc / max(l, 1e-30).
// That is the Pallas function (whose max is refreshed once per bkv-key
// block) and the model's blocked flash attention (repro/models/
// attention.py:120-141) at float32, where rounding p to V's type is the
// identity. Refresh schedule: the running max is refreshed once per key
// tile of 64 keys, whatever `chunk` (the model's chunk_kv) says. At
// float32 every schedule computes the same function and moves only float32
// rounding (the bf16 kernel must follow chunk_kv, because there the max
// decides how p rounds to bf16), and one pass per tile halves the Q K^T
// work of refreshing once per chunk, which needs a pass for the chunk's
// max first. Query i sits at position q_offset + i; keys at or beyond
// kv_len are masked, and keys at or beyond kv_len are never read (their
// shared-memory rows are zero-filled): nothing is padded (the reference's
// wrapper pads KV with zero keys that stay unmasked when q_offset + Sq >
// Skv).
//
// Window: key j is seen by query i (at position q_offset + i) iff j <= i
// (causal), i - j < window and j < kv_len, the model's mask (repro/models/
// attention.py:144-147). A block starts at the key tile that holds its
// first query's first key in the window; the tiles before it are not
// staged. A tile wholly masked for a row changes nothing: before the row's
// first unmasked tile its running sums are scaled away by corr =
// exp(-1e30 - m) = 0 exactly, after it they gain p = 0. A row whose window
// holds no key below kv_len is undefined.
//
// Layouts (row-major, contiguous, float32, 16-byte aligned): q, o (B, Sq,
// H, hd); k, v (B, Skv, K, hd); H = K * G, query head h = kv head h / G,
// group h % G; hd is any multiple of 8 from 8 to 256. The kernel is
// instantiated for the padded width HDP, hd rounded up to a multiple of
// 16 (the narrow tiling's 16 lanes a row): Q, K and V rows are staged with
// zeros in the columns from hd to HDP, which add exactly nothing to a
// score's sum, and the output columns from hd on are not written.
//
// Design: the rows of (query, group) pairs of one kv head, all Sq * G of
// them in query-major order, are cut into row tiles; a block of 1, 2 or 4
// warps takes one row tile of one (batch row, kv head), so the G query
// heads share every K/V tile, and the grid launches the last row tiles
// first, since causal work grows with a row tile's index. A row group of
// TPR lanes owns R = 8 rows of the tile (rows rg, rg + n_rg, ...); each
// lane holds an R x C micro-tile of scores (its rows x keys kg, kg + TPR,
// ... of the key tile) and, for P V, the same rows x hd / TPR columns of
// O in registers. Two tilings (`Tiling`):
//   wide, TPR = 8: 8 x 8 scores and 8 x hd / 8 outputs a lane, 32 rows a
//     warp, 128 rows a block of 4 warps. Per 4 dims of Q K^T (and per 4
//     keys of P V) a lane loads 16 float4 from shared memory for 256 FMAs;
//   narrow, TPR = 16: 8 x 4 and 8 x hd / 16, 16 rows a warp, 12 float4 per
//     128 FMAs.
// Counting one shared-memory cycle per float a lane loads (broadcast or
// not) against four warps' FMAs a cycle, Q K^T and P V are bound by the
// loads in the narrow tiling (3 floats per 32 FMAs) and balanced in the
// wide one (4 per 64), which was 17% faster at S = 1024 on an H100; but a
// wide row tile takes twice as long, which a grid of few blocks waits for
// (it was slower at S <= 512). So the launch takes
// the wide tiling where its 4-warp blocks still give every SM two (at the
// full-width serve's B = 2, H = 32, K = 8: S = 1024), else the narrow one
// in the largest block that still gives every SM one (4 warps at S = 256
// and 512, 2 at 128; at the parity serve's B = 1: 1 warp at S = 96, 2 at
// 200). hd = 128 takes the narrow tiling only: the wide one's
// accumulators would not fit registers. The row max and the row sum are
// reduced by xor shuffles within the row group, so all its lanes hold the
// same m and l. P goes to shared memory and each row group reads back only
// its own rows (a __syncwarp, no block barrier). Shared memory holds Q's
// row tile for the whole launch, P, and one K and one V tile, each loaded
// by cp.async, 16 bytes a lane: the next K tile while softmax and P V run,
// the next V tile while the next Q K^T runs (one stage each, so that two
// wide or three narrow blocks fit an SM). Rows are padded (Q, K, V to
// hd + 4 floats, P to 64 + TPR) so that no read above meets a bank
// conflict. Only tiles that reach past the block's first query or past
// kv_len are masked; tiles after the block's last query are not visited.
// No atomics and a fixed order of sums, so a launch is deterministic.
//
// What bounds it: one launch must read Q, K, V and write O once, and does
// 4 * B * H * hd * (causal pairs) operations, on the float32 CUDA cores
// (67 TFLOP/s peak): at the serve's shapes (hd = 64, H = 32, K = 8, B = 2,
// S = 128-1024) it is bound by those operations. Beyond them it issues the
// shared-memory loads above, per score a scale, a mask on edge tiles, an
// expf, a sum and a share of the row's shuffles, and computes the masked
// scores of diagonal tiles.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int BKV = 64;            // keys per tile
constexpr int R = 8;               // rows per thread
constexpr int MAX_WARPS = 4;
constexpr float NEG_INF = -1e30f;

// how a block's threads share the work: HD_ is the padded head dimension,
// TPR_ the lanes of a row group (8: a thread's score micro-tile is R x 8 keys
// and its accumulator R x hd / 8; 16: R x 4 and R x hd / 16)
template <int HD_, int TPR_>
struct Tiling {
  static constexpr int HD = HD_;
  static constexpr int TPR = TPR_;
  static constexpr int C = BKV / TPR;          // keys per thread
  static constexpr int CPT = HD / TPR;         // columns of O per thread
  static constexpr int ROWS_PER_WARP = 32 / TPR * R;
  static constexpr int RS = HD + 4;            // Q, K, V row stride (floats)
  // P's row stride: the row groups of a warp write adjacent rows, TPR
  // floats each, into distinct banks
  static constexpr int PS = BKV + TPR;
};

// argument errors, returned as negative codes
constexpr int ERR_SHAPE = -1;
constexpr int ERR_HEAD_DIM = -2;
constexpr int ERR_KV_LEN = -4;
constexpr int ERR_ALIGN = -5;
constexpr int MAX_HD = 256;

// dynamic shared memory of a block of `warps` warps: Q, P, one K tile and
// one V tile
template <class T>
constexpr size_t smem_bytes(int warps) {
  return sizeof(float) *
         (static_cast<size_t>(warps) * T::ROWS_PER_WARP * (T::RS + T::PS)
          + 2 * BKV * T::RS);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  // src-size 0 reads nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// stage key rows [t0, t0 + BKV) of K or V (`src`, rows `stride` floats
// apart) into `dst`, and commit them as one copy group; rows at or beyond
// kv_len, and the columns at or beyond hd, are zero-filled and not read
template <class T>
__device__ __forceinline__ void stage_tile(const float* src, size_t stride,
                                           int t0, int kv_len, int hd,
                                           float* dst) {
  constexpr int CH = T::HD / 4;
  constexpr int KS = T::RS;
  for (int e = threadIdx.x; e < BKV * CH; e += blockDim.x) {
    const int j = e / CH, c = e - j * CH, kp = t0 + j;
    const bool in = kp < kv_len && 4 * c < hd;
    cp_async16(dst + j * KS + 4 * c,
               src + static_cast<size_t>(in ? kp : 0) * stride + 4 * c, in);
  }
  cp_async_commit();
}

// reductions over the TPR lanes of a row group
template <int TPR>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// every lane of the group gets the same bits: each butterfly step adds the
// same two values, and float addition commutes
template <int TPR>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// WIN = false: a launch with no window, where the window's tests vanish
// (a runtime test slowed the dense serves' S = 1024 launch by 6%); WIN =
// true takes any window, and every launch at HD > 128
template <class T, bool WIN>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int B, int Sq, int Skv, int H, int K, int hd,
                       int q_offset, int kv_len, int causal, int window,
                       int n_tiles, float scale) {
  constexpr int HD = T::HD;
  constexpr int TPR = T::TPR, C = T::C, CPT = T::CPT, PS = T::PS;
  constexpr int QS = T::RS, KS = T::RS;
  extern __shared__ __align__(16) float smem[];
  const int n_rg = blockDim.x / TPR;   // row groups in the block
  const int rows = n_rg * R;
  float* qs = smem;
  float* ps = qs + rows * QS;
  float* ks = ps + rows * PS;
  float* vs = ks + BKV * KS;

  const int G = H / K;
  int id = blockIdx.x;
  const int kh = id % K;
  id /= K;
  const int b = id % B;
  const int tile = n_tiles - 1 - id / B;    // heaviest row tiles first
  const int n_rows = Sq * G;
  const int r0 = tile * rows;
  const int q_first = q_offset + r0 / G;
  const int q_last = q_offset + (min(r0 + rows, n_rows) - 1) / G;
  // keys the block needs (causal: up to its last query); a tile that ends
  // at or before `clean` holds no masked key for any row of the block
  const int n_keys = causal ? min(kv_len, q_last + 1) : kv_len;
  const int clean = causal ? min(kv_len, q_first + 1) : kv_len;
  // with a window: the block's first key tile, and the first key from
  // which every row of the block sees every key (before it tiles are
  // masked)
  const bool win = WIN && window > 0;
  const int t_first = win ? max(0, q_first - window + 1) / BKV : 0;
  const int w_clean = win ? q_last - window + 1 : 0;

  const int tid = threadIdx.x;
  const int rg = tid / TPR, kg = tid % TPR;
  const size_t kv_stride = static_cast<size_t>(K) * hd;
  const float* kb = k + static_cast<size_t>(b) * Skv * kv_stride + kh * hd;
  const float* vb = v + static_cast<size_t>(b) * Skv * kv_stride + kh * hd;

  // copy groups in flight: Q's row tile with the first K tile, then the
  // first V tile
  for (int e = tid; e < rows * (HD / 4); e += blockDim.x) {
    const int lr = e / (HD / 4), c = e - lr * (HD / 4);
    const int r = r0 + lr;
    const bool in = r < n_rows && 4 * c < hd;
    const int qi = r < n_rows ? r / G : 0;
    const int g = r < n_rows ? r - qi * G : 0;
    cp_async16(qs + lr * QS + 4 * c,
               q + ((static_cast<size_t>(b) * Sq + qi) * H + kh * G + g) * hd
                   + (in ? 4 * c : 0),
               in);
  }
  stage_tile<T>(kb, kv_stride, t_first * BKV, kv_len, hd, ks);
  stage_tile<T>(vb, kv_stride, t_first * BKV, kv_len, hd, vs);

  // this thread's rows: rg + n_rg * i of the row tile
  float m[R], l[R], acc[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
  }

  const int n_kt = (n_keys + BKV - 1) / BKV;
  for (int t = t_first; t < n_kt; ++t) {
    const int t0 = t * BKV;
    const bool more = t + 1 < n_kt;
    cp_async_wait<1>();      // K tile t is in (this thread's copies) ...
    __syncthreads();         // ... and every thread's
    const float* kt = ks;
    const float* vt = vs;

    // s = Q K^T: an R x C micro-tile, R * C independent FMA chains
    float s[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 kk[C];
#pragma unroll
      for (int j = 0; j < C; ++j)
        kk[j] = *reinterpret_cast<const float4*>(kt + (kg + TPR * j) * KS
                                                 + d);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(
            qs + (rg + n_rg * i) * QS + d);
#pragma unroll
        for (int j = 0; j < C; ++j) {
          s[i][j] = fmaf(qq.x, kk[j].x, s[i][j]);
          s[i][j] = fmaf(qq.y, kk[j].y, s[i][j]);
          s[i][j] = fmaf(qq.z, kk[j].z, s[i][j]);
          s[i][j] = fmaf(qq.w, kk[j].w, s[i][j]);
        }
      }
    }

    cp_async_wait<0>();      // V tile t is in
    __syncthreads();         // ... everywhere, and K tile t is read
    // the next K tile loads during softmax and P V
    if (more) stage_tile<T>(kb, kv_stride, t0 + BKV, kv_len, hd, ks);

    // online softmax, one refresh per tile; p to shared memory
    const bool edge = t0 + BKV > clean || (win && t0 < w_clean);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = q_offset + (r0 + rg + n_rg * i) / G;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        float x = s[i][j] * scale;
        if (edge) {
          const int kp = t0 + kg + TPR * j;
          const bool keep = kp < kv_len && (!causal || kp <= qpos)
                            && (!win || qpos - kp < window);
          x = keep ? x : NEG_INF;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], group_max<TPR>(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
      float* pr = ps + (rg + n_rg * i) * PS + kg;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        pr[TPR * j] = p;
      }
      l[i] = l[i] * corr + group_sum<TPR>(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncwarp();            // the row group's p rows are written

    // acc += P V: R rows x CPT columns per thread
#pragma unroll 2
    for (int j = 0; j < BKV; j += 4) {
      float4 pp[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        pp[i] = *reinterpret_cast<const float4*>(ps + (rg + n_rg * i) * PS
                                                 + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vr = vt + (j + jj) * KS;
        float vv[CPT];
        if constexpr (CPT % 4 == 0) {
#pragma unroll
          for (int ch = 0; ch < CPT / 4; ++ch) {
            const float4 x = *reinterpret_cast<const float4*>(
                vr + 4 * TPR * ch + 4 * kg);
            vv[4 * ch] = x.x;
            vv[4 * ch + 1] = x.y;
            vv[4 * ch + 2] = x.z;
            vv[4 * ch + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < CPT; ++c) vv[c] = vr[kg + TPR * c];
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float p = jj == 0 ? pp[i].x : jj == 1 ? pp[i].y
                        : jj == 2 ? pp[i].z : pp[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();         // V tile t and P are read
    // the next V tile loads during the next Q K^T
    if (more) stage_tile<T>(vb, kv_stride, t0 + BKV, kv_len, hd, vs);
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + rg + n_rg * i;
    if (r >= n_rows) continue;
    const int qi = r / G, g = r - qi * G;
    float* orow = o + ((static_cast<size_t>(b) * Sq + qi) * H + kh * G + g)
                          * hd;
    const float l_safe = fmaxf(l[i], 1e-30f);
    // only the columns below hd (hd is a multiple of 4, so a float4 group
    // lies wholly below it or wholly in the padding)
    if constexpr (CPT % 4 == 0) {
#pragma unroll
      for (int ch = 0; ch < CPT / 4; ++ch)
        if (4 * TPR * ch + 4 * kg < hd)
          *reinterpret_cast<float4*>(orow + 4 * TPR * ch + 4 * kg) =
              make_float4(acc[i][4 * ch] / l_safe,
                          acc[i][4 * ch + 1] / l_safe,
                          acc[i][4 * ch + 2] / l_safe,
                          acc[i][4 * ch + 3] / l_safe);
    } else {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        if (kg + TPR * c < hd) orow[kg + TPR * c] = acc[i][c] / l_safe;
    }
  }
}

// SMs of the current device, asked once
int sm_count() {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      n_sm = 1;
  }
  return n_sm;
}

// row tiles of `warps`-warp blocks over n_rows rows
template <class T>
int row_tiles(int n_rows, int warps) {
  const int rows = warps * T::ROWS_PER_WARP;
  return (n_rows + rows - 1) / rows;
}

template <class T>
int launch_tiled(int warps, int B, int Sq, int Skv, int H, int K, int hd,
                 int q_offset, int kv_len, int causal, int window,
                 const void* q, const void* k, const void* v, void* o,
                 cudaStream_t stream) {
  constexpr bool FAST = T::HD <= 128;  // has a WIN = false instance
  auto kernel = flash_attention_kernel<T, true>;
  if constexpr (FAST) {
    if (window == 0) kernel = flash_attention_kernel<T, false>;
  }
  static bool sized = false;
  if (!sized) {
    auto size = [](auto fn) {
      return cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem_bytes<T>(MAX_WARPS)));
    };
    cudaError_t err = size(flash_attention_kernel<T, true>);
    if constexpr (FAST) {
      if (err == cudaSuccess) err = size(flash_attention_kernel<T, false>);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const int n_tiles = row_tiles<T>(Sq * (H / K), warps);
  // 1/sqrt(hd) rounded once to float32, as the reference's float64 scale
  const float scale =
      static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  kernel<<<n_tiles * B * K, 32 * warps, smem_bytes<T>(warps), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), B, Sq, Skv, H, K,
      hd, q_offset, kv_len, causal, window, n_tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

// The wide tiling where its 4-warp blocks still give every SM two, else
// the narrow one in the largest block that still gives every SM one (see
// the header).
template <int HD>
int launch_hd(int B, int Sq, int Skv, int H, int K, int hd, int q_offset,
              int kv_len, int causal, int window, const void* q,
              const void* k, const void* v, void* o, cudaStream_t stream) {
  using Wide = Tiling<HD, 8>;
  using Narrow = Tiling<HD, 16>;
  const int n_rows = Sq * (H / K);
  const long long heads = static_cast<long long>(B) * K;
  if constexpr (HD <= 64) {
    if (row_tiles<Wide>(n_rows, MAX_WARPS) * heads >= 2LL * sm_count())
      return launch_tiled<Wide>(MAX_WARPS, B, Sq, Skv, H, K, hd, q_offset,
                                kv_len, causal, window, q, k, v, o, stream);
  }
  int warps = MAX_WARPS;
  while (warps > 1 && row_tiles<Narrow>(n_rows, warps) * heads < sm_count())
    warps /= 2;
  return launch_tiled<Narrow>(warps, B, Sq, Skv, H, K, hd, q_offset, kv_len,
                              causal, window, q, k, v, o, stream);
}

// the instantiation for the padded width HDP = hd rounded up to 16
template <int HD>
int launch_padded(int hdp, int B, int Sq, int Skv, int H, int K, int hd,
                  int q_offset, int kv_len, int causal, int window,
                  const void* q, const void* k, const void* v, void* o,
                  cudaStream_t stream) {
  if (hdp == HD)
    return launch_hd<HD>(B, Sq, Skv, H, K, hd, q_offset, kv_len, causal,
                         window, q, k, v, o, stream);
  if constexpr (HD < MAX_HD)
    return launch_padded<HD + 16>(hdp, B, Sq, Skv, H, K, hd, q_offset,
                                  kv_len, causal, window, q, k, v, o,
                                  stream);
  return ERR_HEAD_DIM;
}

}  // namespace

extern "C" {

// q, k, v and o float32, contiguous, 16-byte aligned. window: 0 for none,
// else keys window or more positions before the query are masked. chunk:
// the model's chunk_kv (>= 1); checked, but this kernel refreshes its
// running max once per 64-key tile whatever it is (see the header).
// Returns 0, a negative argument error, or the cudaError_t of the launch.
int flash_attention_launch(int B, int Sq, int Skv, int H, int K, int hd,
                           int q_offset, int kv_len, int causal, int window,
                           int chunk, const void* q, const void* k,
                           const void* v, void* o, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || K < 1 || H < K || H % K != 0 ||
      q_offset < 0 || chunk < 1 || window < 0)
    return ERR_SHAPE;
  if (kv_len < 1 || kv_len > Skv) return ERR_KV_LEN;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return ERR_ALIGN;
  if (hd < 8 || hd > MAX_HD || hd % 8 != 0) return ERR_HEAD_DIM;
  return launch_padded<16>((hd + 15) / 16 * 16, B, Sq, Skv, H, K, hd,
                           q_offset, kv_len, causal, window, q, k, v, o,
                           static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error(int code) {
  switch (code) {
    case ERR_SHAPE:
      return "need B, Sq, Skv, K, chunk >= 1, H a multiple of K, "
             "q_offset >= 0 and window >= 0";
    case ERR_HEAD_DIM: return "head_dim must be a multiple of 8 in 8..256";
    case ERR_KV_LEN: return "kv_len must lie in 1..Skv";
    case ERR_ALIGN: return "q, k, v and o must be 16-byte aligned";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
