// Causal GQA flash-attention forward in float32 for sm_90a: online softmax
// over key tiles, one thread block per (q tile, kv head, batch row).
//
// Replaces the Pallas kernel repro/kernels/flash_attention/kernel.py
// (`flash_attention_fwd`, body `_kernel`) for float32 inputs; bfloat16
// inputs take the tensor-core kernel csrc/flash_attention_tc.cu. It runs
// on the float32 CUDA cores and not in TF32, which would break the
// reference's float32 contract (2e-5). For every query row of every query
// head it computes, in float32:
//   s_j = (q . k_j) * (1/sqrt(hd)), masked to -1e30 where the key is after
//         the query (causal) or at or beyond kv_len;
//   per chunk of `chunk` keys (from key 0): m_new = max(m, max_j s_j);
//         corr = exp(m - m_new); p_j = exp(s_j - m_new);
//         l = l*corr + sum_j p_j; acc = acc*corr + sum_j p_j v_j;
//   out = acc / max(l, 1e-30).
// That is the Pallas function and the model's blocked flash attention
// (repro/models/attention.py:120-141) at float32, where rounding p to V's
// type is the identity. The kernel refreshes the max once per chunk of the
// model's chunk_kv keys (1024 by default), as the model does, and not once
// per shared-memory tile. Each chunk takes two passes over its key tiles:
// the first finds its max, the second recomputes the same scores (bit for
// bit) and accumulates; that costs one more QK product per key. Query i
// sits at position q_offset + i; keys at or beyond kv_len are masked, and
// keys beyond Skv are never read: nothing is padded (the reference's
// wrapper pads KV with zero keys that stay unmasked when q_offset + Sq >
// Skv).
//
// Layouts (row-major, contiguous, float32): q, o (B, Sq, H, hd); k, v (B,
// Skv, K, hd); H = K * G, query head h = kv head h / G, group h % G; hd is
// 16, 32, 64 or 128.
//
// Design: a block takes BQ consecutive queries of one batch row and all G
// query heads of one kv head, BQ * G <= 128 rows, one thread per row: the
// G heads share every K/V tile, which the block stages in shared memory
// (BKV keys at a time; the max pass stages only K). Each thread keeps its
// query row, its accumulator and the tile's scores in registers
// and reads the tile by broadcast (at hd = 128, llama3.2-3b, the registers
// spill to the stack). Tiles wholly after the block's last query (causal)
// or at or beyond kv_len are skipped: every score in them is -1e30, so
// their p is exactly 0 and they would change nothing.
//
// What bounds it: one launch must read Q, K, V and write O once, and does
// 4 * B * H * hd * (causal pairs) operations, on the float32 CUDA cores
// (67 TFLOP/s peak), one row per thread: it is bound by those operations
// and by the shared-memory reads that feed them. It serves the float32
// paths (the card-vs-CPU parity serve, the tests); the bf16 serve takes
// the tensor-core kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_ROWS = 128;      // threads (rows) per block
constexpr int BKV = 32;            // keys per tile
constexpr float NEG_INF = -1e30f;

// argument errors, returned as negative codes
constexpr int ERR_SHAPE = -1;
constexpr int ERR_HEAD_DIM = -2;
constexpr int ERR_GROUP = -3;
constexpr int ERR_KV_LEN = -4;

// scores of one tile of keys [t0, t0 + BKV) for this thread's query row:
// -1e30 where the key is at or beyond `hi` (the chunk's end, or kv_len) or
// after the query (causal)
template <int HD>
__device__ __forceinline__ void tile_scores(const float* ks, const float* qr,
                                            int t0, int hi, int qpos,
                                            int causal, float scale,
                                            float* s) {
#pragma unroll
  for (int j = 0; j < BKV; ++j) {
    const float4* kr = reinterpret_cast<const float4*>(ks + j * HD);
    float dot = 0.0f;
#pragma unroll
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 kk = kr[d4];
      dot = fmaf(qr[4 * d4], kk.x, dot);
      dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
      dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
      dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
    }
    const int kp = t0 + j;
    const bool keep = kp < hi && (!causal || kp <= qpos);
    s[j] = keep ? dot * scale : NEG_INF;
  }
}

// stage keys [t0, t0 + BKV) of K (and of V when `vs`); keys at or beyond
// Skv read as 0 and are masked by tile_scores
template <int HD>
__device__ __forceinline__ void stage_tile(const float* kb, const float* vb,
                                           size_t kv_stride, int t0, int Skv,
                                           float* ks, float* vs) {
  for (int e = threadIdx.x; e < BKV * HD; e += blockDim.x) {
    const int j = e / HD, d = e - j * HD, kp = t0 + j;
    const bool in = kp < Skv;
    ks[e] = in ? kb[kp * kv_stride + d] : 0.0f;
    if (vs) vs[e] = in ? vb[kp * kv_stride + d] : 0.0f;
  }
}

template <int HD>
__global__ void __launch_bounds__(MAX_ROWS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int Sq, int Skv, int H, int K, int BQ, int q_offset,
                       int kv_len, int causal, int chunk, float scale) {
  __shared__ __align__(16) float ks[BKV * HD];
  __shared__ __align__(16) float vs[BKV * HD];
  const int G = H / K;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int q_end = min(q0 + BQ, Sq);
  const int r = threadIdx.x;
  const int qi = q0 + r / G;
  const int h = kh * G + r % G;
  const bool active = r < BQ * G && qi < Sq;
  const int qpos = q_offset + qi;

  // keys this block needs: causal stops after its last query
  int n_keys = kv_len;
  if (causal) n_keys = min(n_keys, q_offset + q_end);

  float qr[HD], acc[HD];
  const size_t row = ((static_cast<size_t>(b) * Sq + qi) * H + h) * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = active ? q[row + d] : 0.0f;
    acc[d] = 0.0f;
  }
  float m = NEG_INF, l = 0.0f;

  const size_t kv_stride = static_cast<size_t>(K) * HD;
  const float* kb = k + static_cast<size_t>(b) * Skv * kv_stride + kh * HD;
  const float* vb = v + static_cast<size_t>(b) * Skv * kv_stride + kh * HD;
  float s[BKV];
  for (int c0 = 0; c0 < n_keys; c0 += chunk) {
    const int hi = min(c0 + chunk, kv_len);
    const int c_end = min(c0 + chunk, n_keys);
    // pass 1: the chunk's max
    float m_new = m;
    for (int t0 = c0; t0 < c_end; t0 += BKV) {
      __syncthreads();    // the previous tile is no longer read
      stage_tile<HD>(kb, vb, kv_stride, t0, Skv, ks, nullptr);
      __syncthreads();
      if (!active) continue;
      tile_scores<HD>(ks, qr, t0, hi, qpos, causal, scale, s);
#pragma unroll
      for (int j = 0; j < BKV; ++j) m_new = fmaxf(m_new, s[j]);
    }
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= corr;
    // pass 2: the same scores again, p against the chunk's max
    for (int t0 = c0; t0 < c_end; t0 += BKV) {
      __syncthreads();
      stage_tile<HD>(kb, vb, kv_stride, t0, Skv, ks, vs);
      __syncthreads();
      if (!active) continue;
      tile_scores<HD>(ks, qr, t0, hi, qpos, causal, scale, s);
#pragma unroll
      for (int j = 0; j < BKV; ++j) {
        const float p = expf(s[j] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(vs + j * HD);
#pragma unroll
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
    }
    m = m_new;
  }
  if (!active) return;
  const float l_safe = fmaxf(l, 1e-30f);
#pragma unroll
  for (int d = 0; d < HD; ++d) o[row + d] = acc[d] / l_safe;
}

template <int HD>
int launch_hd(int B, int Sq, int Skv, int H, int K, int q_offset, int kv_len,
              int causal, int chunk, const void* q, const void* k,
              const void* v, void* o, cudaStream_t stream) {
  const int G = H / K;
  const int BQ = MAX_ROWS / G;
  const int rows = BQ * G;
  const int threads = (rows + 31) / 32 * 32;
  const dim3 grid((Sq + BQ - 1) / BQ, K, B);
  // 1/sqrt(hd) rounded once to float32, as the reference's float64 scale
  const float scale =
      static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  flash_attention_kernel<HD><<<grid, threads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, K,
      BQ, q_offset, kv_len, causal, chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v and o float32. chunk: keys per max refresh (>= 1; the model's
// chunk_kv).
// Returns 0, a negative argument error, or the cudaError_t of the launch.
int flash_attention_launch(int B, int Sq, int Skv, int H, int K, int hd,
                           int q_offset, int kv_len, int causal, int chunk,
                           const void* q, const void* k, const void* v,
                           void* o, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || K < 1 || H < K || q_offset < 0 ||
      chunk < 1)
    return ERR_SHAPE;
  if (H % K != 0 || H / K > MAX_ROWS) return ERR_GROUP;
  if (kv_len < 1 || kv_len > Skv) return ERR_KV_LEN;
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<16>(B, Sq, Skv, H, K, q_offset, kv_len, causal,
                                  chunk, q, k, v, o, st);
    case 32: return launch_hd<32>(B, Sq, Skv, H, K, q_offset, kv_len, causal,
                                  chunk, q, k, v, o, st);
    case 64: return launch_hd<64>(B, Sq, Skv, H, K, q_offset, kv_len, causal,
                                  chunk, q, k, v, o, st);
    case 128: return launch_hd<128>(B, Sq, Skv, H, K, q_offset, kv_len,
                                    causal, chunk, q, k, v, o, st);
    default: return ERR_HEAD_DIM;
  }
}

const char* flash_attention_error(int code) {
  switch (code) {
    case ERR_SHAPE:
      return "need B, Sq, Skv, K, chunk >= 1, H >= K and q_offset >= 0";
    case ERR_HEAD_DIM: return "head_dim must be 16, 32, 64 or 128";
    case ERR_GROUP:
      return "H must be a multiple of K with at most 128 heads per kv head";
    case ERR_KV_LEN: return "kv_len must lie in 1..Skv";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
