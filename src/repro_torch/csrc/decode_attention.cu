// Decode attention: one new query token per cache slot against that slot's
// filled KV-cache rows, GQA, read in place from the cache in its own dtype,
// the sequence split across blocks (sm_90a).
//
// Replaces no Pallas kernel. The JAX package's decode attention
// (repro/models/attention.py, `decode`) is plain jnp: two einsums over the
// whole cache window with a mask, which the port ran as such
// (kernels/decode_attention/kernel.py `decode_attention_plain`, the CPU and
// mesh path). On the card that version copied every layer's whole K cache
// to float32 and both einsums made permuted copies of K and V, ~15-45x the
// bytes the step needs; this kernel reads each filled row once.
//
// What it computes, for slot b, kv head kh and query head h = kh * G + g
// (G = H / K), all in float32 from the operands:
//   n   = min(pos[b] + 1, W) (at least 1): the rows 0..n-1 are the ones the
//         plain version's mask keeps, in clamp mode (rows <= min(pos, W-1))
//         and in ring mode (rows <= pos % W, or every row once pos >= W);
//         the softmax does not depend on row order, so the ring needs
//         nothing else;
//   s_j = (q_h . k_j) * (1/sqrt(hd)), times ks[b, j, kh] for an int8 cache;
//   m   = max_j s_j,  p_j = expf(s_j - m),  l = sum_j p_j;
//   o_h = (sum_j p_j v_j) / l, each p_j times vs[b, j, kh] for an int8
//         cache, rounded to q's dtype once.
// The plain version rounds the weights to q's dtype before P V; this one
// keeps them in float32, so it is at least as exact.
//
// Layouts (row-major, contiguous): q, o (B, H, hd) in bf16 or float32;
// k, v (B, W, K, hd) in q's dtype, or int8 with ks, vs (B, W, K) bf16;
// pos (B,) int32 or int64, read on the device (no host sync); part, the
// splits' partial results, (B, H, n_split, hd + 2) float32.
//
// What bounds it: bytes. A launch must read every filled row's K and V
// once, n * K * hd * 2 * itemsize per slot, plus q and o; at the benchmark
// cell's shape (16 slots, W = 12,336, K = 8, hd = 128, bf16) that is 808 MB
// at full fill, 0.241 ms at 3.35 TB/s, and about a third of it at a typical
// fill. Its operations, 4 * G * hd a row and kv head, are ~2 per byte read,
// far below the card's ~20 float32 operations a byte.
//
// Design, against that bound:
// - Filled rows only: the grid is (split, kv head, slot) with SPLIT_ROWS
//   rows a split; n_split = ceil(W / SPLIT_ROWS) comes from the shape, so
//   the host never reads a fill, and a block whose split starts at or past
//   its slot's n exits at once (idle slots, n = 1, cost one block a head).
//   16 slots x 8 kv heads are 128 blocks, fewer than the 132 SMs, hence the
//   split: 49 splits a head at W = 12,336.
// - Each K and V row read once: one block serves all G query heads of its
//   kv head; q's G rows sit in registers.
// - 16-byte loads: a lane reads 8 consecutive elements of a row (16 bytes
//   of bf16, 32 of float32 as two loads, 8 of int8); LPR = hd / 8 lanes
//   (rounded up to a power of two, at least 4) cover a row, so a warp reads
//   32 / LPR rows at once and STEP rows an iteration, all loads of an
//   iteration issued before their use.
// - Two passes a warp over its WARP_ROWS rows, no running rescale: the
//   scores of the warp's rows go to shared memory with the warp's max per
//   head; the second pass reads V and sums p_j and p_j v_j against that
//   max. The 4 warps of a block merge by their maxima in shared memory.
// - Splits merge in a second launch (`decode_attention_combine`, one block
//   a query head and slot): their maxima and weights in shared memory, then
//   each output element summed over the splits in split order, loads
//   unrolled so that they overlap; a single split (W <= SPLIT_ROWS) writes
//   o directly. No atomics: a launch is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int SPLIT_ROWS = 256;                // cache rows a block reads
constexpr int WARP_ROWS = SPLIT_ROWS / WARPS;  // of them, a warp's
constexpr int MAX_G = 8;
constexpr int MAX_HD = 256;
constexpr int MAX_SPLITS = 1024;               // W <= 262,144 rows
constexpr unsigned FULL = 0xffffffffu;

// argument errors, returned as negative codes
constexpr int ERR_SHAPE = -1;
constexpr int ERR_HEAD_DIM = -2;
constexpr int ERR_GROUP = -3;
constexpr int ERR_ALIGN = -4;
constexpr int ERR_DTYPE = -5;
constexpr int ERR_SPLITS = -6;

// dtype codes of the C interface
constexpr int DT_BF16 = 0;
constexpr int DT_F32 = 1;
constexpr int DT_I8 = 2;

// 8 consecutive elements of a row, the unit one lane loads
template <typename T>
struct Pack;

template <>
struct Pack<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void to_float(float* f) const {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Pack<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void zero() {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
  }
  __device__ __forceinline__ void to_float(float* f) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

template <>
struct Pack<int8_t> {
  uint2 u;
  __device__ __forceinline__ void load(const int8_t* p) {
    u = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void zero() { u = make_uint2(0, 0); }
  __device__ __forceinline__ void to_float(float* f) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = static_cast<float>(static_cast<int8_t>(u.x >> (8 * i)));
      f[4 + i] = static_cast<float>(static_cast<int8_t>(u.y >> (8 * i)));
    }
  }
};

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// the filled rows of slot b: min(pos[b] + 1, W), at least 1
__device__ __forceinline__ int filled_rows(const void* pos, int pos64, int b,
                                           int W) {
  const long long p = pos64 ? static_cast<const long long*>(pos)[b]
                            : static_cast<const int*>(pos)[b];
  return static_cast<int>(p + 1 < 1 ? 1 : (p + 1 > W ? W : p + 1));
}

template <typename TQ, typename TC, int LPR, int GT>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const TQ* __restrict__ q, const TC* __restrict__ k,
                        const TC* __restrict__ v,
                        const __nv_bfloat16* __restrict__ ks,
                        const __nv_bfloat16* __restrict__ vs,
                        const void* __restrict__ pos, int pos64, int W, int H,
                        int K, int hd, int n_split, float scale,
                        float* __restrict__ part, TQ* __restrict__ out) {
  constexpr int RPW = 32 / LPR;                   // rows a warp reads at once
  constexpr int STEP = sizeof(TC) == 4 ? 8 : 16;  // rows a warp iteration
  constexpr int U = STEP / RPW;                   // of them, a lane's
  constexpr int HDM = 8 * LPR;                    // widest row it takes
  constexpr bool SCALED = sizeof(TC) == 1;        // int8, with ks and vs
  __shared__ float s_score[WARPS][WARP_ROWS][GT];
  __shared__ float s_m[WARPS][GT];
  __shared__ float s_l[WARPS][GT];
  __shared__ float s_acc[WARPS][GT][HDM];

  const int b = blockIdx.z, kh = blockIdx.y, split = blockIdx.x;
  const int n = filled_rows(pos, pos64, b, W);
  const int r0 = split * SPLIT_ROWS;
  if (r0 >= n) return;                            // the whole block
  const int G = H / K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPR, sub = lane % LPR;
  const bool on = sub * 8 < hd;                   // lanes past hd read nothing
  const int lo = r0 + warp * WARP_ROWS;
  const int hi = min(lo + WARP_ROWS, n);
  const size_t row = static_cast<size_t>(K) * hd;  // elements between rows
  const size_t head0 = (static_cast<size_t>(b) * W * K + kh) * hd + sub * 8;
  const TC* kb = k + head0;
  const TC* vb = v + head0;
  const size_t sc0 = static_cast<size_t>(b) * W * K + kh;  // ks[b, 0, kh]

  float qf[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < G && on) {
      Pack<TQ> p;
      p.load(q + (static_cast<size_t>(b) * H + kh * G + g) * hd + sub * 8);
      p.to_float(qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[g][e] = 0.f;
    }
  }

  // pass 1: the scores of the warp's rows and their max per head
  float m[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) m[g] = -INFINITY;
  for (int t = lo; t < hi; t += STEP) {
    Pack<TC> kp[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = t + u * RPW + grp;
      if (on && j < hi) kp[u].load(kb + j * row);
      else kp[u].zero();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = t + u * RPW + grp;
      float kf[8];
      kp[u].to_float(kf);
      float s[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) a = fmaf(qf[g][e], kf[e], a);
        s[g] = a;
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int g = 0; g < GT; ++g) s[g] += __shfl_xor_sync(FULL, s[g], off);
      }
      if (j < hi) {
        const float f =
            SCALED ? __bfloat162float(ks[sc0 + static_cast<size_t>(j) * K])
                   : 1.f;
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          s[g] *= scale;
          if (SCALED) s[g] *= f;
          m[g] = fmaxf(m[g], s[g]);
          if (sub == 0) s_score[warp][j - lo][g] = s[g];
        }
      }
    }
  }
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g)
      m[g] = fmaxf(m[g], __shfl_xor_sync(FULL, m[g], off));
  }
  __syncwarp();

  // pass 2: p = expf(s - m), its sum and the weighted sum of V
  float l[GT], acc[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }
  for (int t = lo; t < hi; t += STEP) {
    Pack<TC> vp[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = t + u * RPW + grp;
      if (on && j < hi) vp[u].load(vb + j * row);
      else vp[u].zero();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = t + u * RPW + grp;
      if (j >= hi) continue;
      float vf[8];
      vp[u].to_float(vf);
      const float f =
          SCALED ? __bfloat162float(vs[sc0 + static_cast<size_t>(j) * K])
                 : 1.f;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float p = expf(s_score[warp][j - lo][g] - m[g]);
        l[g] += p;
        const float w = SCALED ? p * f : p;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(w, vf[e], acc[g][e]);
      }
    }
  }
  // the warp's row groups hold sums over their own rows: add them up
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      l[g] += __shfl_xor_sync(FULL, l[g], off);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], off);
    }
  }
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (lane == 0) {
        s_m[warp][g] = m[g];
        s_l[warp][g] = l[g];
      }
      if (on) {
#pragma unroll
        for (int e = 0; e < 8; ++e) s_acc[warp][g][sub * 8 + e] = acc[g][e];
      }
    }
  }
  __syncthreads();

  // merge the warps by their maxima (a warp with no rows has m = -inf;
  // warp 0 always has one); one split writes o, several their partials
  for (int i = threadIdx.x; i < G * hd; i += THREADS) {
    const int g = i / hd, e = i % hd;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, s_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (s_m[w][g] == -INFINITY) continue;
      const float f = expf(s_m[w][g] - M);
      L = fmaf(f, s_l[w][g], L);
      A = fmaf(f, s_acc[w][g][e], A);
    }
    const size_t h = static_cast<size_t>(b) * H + kh * G + g;
    if (n_split == 1) {
      store(out + h * hd + e, A / L);
    } else {
      float* pp = part + (h * n_split + split) * (hd + 2);
      pp[e] = A;
      if (e == 0) {
        pp[hd] = M;
        pp[hd + 1] = L;
      }
    }
  }
}

// x reduced over the block (a max, or a sum in a fixed order), returned to
// every thread; `red` holds WARPS floats
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(FULL, x, off);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

// one block a (query head, slot): the slot's used splits merged by their
// maxima, each output element summed over the splits in split order
template <typename TQ>
__global__ void __launch_bounds__(THREADS)
decode_attention_combine(const float* __restrict__ part,
                         const void* __restrict__ pos, int pos64, int W,
                         int H, int hd, int n_split, TQ* __restrict__ out) {
  __shared__ float s_w[MAX_SPLITS];
  __shared__ float red[WARPS];
  const int h = blockIdx.x, b = blockIdx.y;
  const int used = (filled_rows(pos, pos64, b, W) + SPLIT_ROWS - 1)
                   / SPLIT_ROWS;
  const int stride = hd + 2;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const float* pp = part + bh * n_split * stride;
  float m = -INFINITY;
  for (int s = threadIdx.x; s < used; s += THREADS)
    m = fmaxf(m, pp[s * stride + hd]);
  const float M = block_reduce<true>(m, red);
  float l = 0.f;
  for (int s = threadIdx.x; s < used; s += THREADS) {
    const float w = expf(pp[s * stride + hd] - M);
    s_w[s] = w;
    l = fmaf(w, pp[s * stride + hd + 1], l);
  }
  const float L = block_reduce<false>(l, red);   // its barrier shows s_w
  for (int e = threadIdx.x; e < hd; e += THREADS) {
    float A = 0.f;
#pragma unroll 8
    for (int s = 0; s < used; ++s) A = fmaf(s_w[s], pp[s * stride + e], A);
    store(out + bh * hd + e, A / L);
  }
}

template <typename TQ, typename TC, int LPR, int GT>
int launch(int B, int W, int H, int K, int hd, int n_split, int pos64,
           float scale, const void* q, const void* k, const void* v,
           const void* ks, const void* vs, const void* pos, void* part,
           void* out, cudaStream_t stream) {
  decode_attention_kernel<TQ, TC, LPR, GT>
      <<<dim3(n_split, K, B), THREADS, 0, stream>>>(
          static_cast<const TQ*>(q), static_cast<const TC*>(k),
          static_cast<const TC*>(v), static_cast<const __nv_bfloat16*>(ks),
          static_cast<const __nv_bfloat16*>(vs), pos, pos64, W, H, K, hd,
          n_split, scale, static_cast<float*>(part), static_cast<TQ*>(out));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  decode_attention_combine<TQ><<<dim3(H, B), THREADS, 0, stream>>>(
      static_cast<const float*>(part), pos, pos64, W, H, hd, n_split,
      static_cast<TQ*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC, int LPR>
int launch_g(int G, int B, int W, int H, int K, int hd, int n_split,
             int pos64, float scale, const void* q, const void* k,
             const void* v, const void* ks, const void* vs, const void* pos,
             void* part, void* out, cudaStream_t stream) {
#define DECODE_LAUNCH(GT)                                                  \
  return launch<TQ, TC, LPR, GT>(B, W, H, K, hd, n_split, pos64, scale, q, \
                                 k, v, ks, vs, pos, part, out, stream)
  if (G <= 1) DECODE_LAUNCH(1);
  if (G <= 2) DECODE_LAUNCH(2);
  if (G <= 4) DECODE_LAUNCH(4);
  DECODE_LAUNCH(8);
#undef DECODE_LAUNCH
}

template <typename TQ, typename TC>
int launch_lpr(int G, int B, int W, int H, int K, int hd, int n_split,
               int pos64, float scale, const void* q, const void* k,
               const void* v, const void* ks, const void* vs,
               const void* pos, void* part, void* out, cudaStream_t stream) {
#define DECODE_LAUNCH(LPR)                                                 \
  return launch_g<TQ, TC, LPR>(G, B, W, H, K, hd, n_split, pos64, scale, q, \
                               k, v, ks, vs, pos, part, out, stream)
  if (hd <= 32) DECODE_LAUNCH(4);
  if (hd <= 64) DECODE_LAUNCH(8);
  if (hd <= 128) DECODE_LAUNCH(16);
  DECODE_LAUNCH(32);
#undef DECODE_LAUNCH
}

}  // namespace

extern "C" {

// q, o: (B, H, hd) of dtype q_dtype (0 bf16, 1 float32); k, v: (B, W, K,
// hd) of dtype c_dtype (q_dtype, or 2 for int8 with ks, vs (B, W, K)
// bf16; else ks, vs null); pos (B,) int32 (pos64 = 0) or int64; part:
// (B, H, n_split, hd + 2) float32 scratch, n_split = ceil(W / 256), unused
// when n_split is 1. q, k, v aligned to their 8-element loads (16 bytes,
// int8 8). Returns 0, a negative argument error, or the cudaError_t of a
// launch.
int decode_attention_launch(int B, int W, int H, int K, int hd, int q_dtype,
                            int c_dtype, int pos64, int n_split, float scale,
                            const void* q, const void* k, const void* v,
                            const void* ks, const void* vs, const void* pos,
                            void* part, void* out, void* stream) {
  if (B < 1 || W < 1 || K < 1 || H < K) return ERR_SHAPE;
  if (H % K != 0 || H / K > MAX_G) return ERR_GROUP;
  if (hd < 8 || hd > MAX_HD || hd % 8 != 0) return ERR_HEAD_DIM;
  if (n_split != (W + SPLIT_ROWS - 1) / SPLIT_ROWS || n_split > MAX_SPLITS)
    return ERR_SPLITS;
  const bool int8 = c_dtype == DT_I8;
  if ((q_dtype != DT_BF16 && q_dtype != DT_F32) ||
      (c_dtype != q_dtype && !int8) || (int8 != (ks && vs)) || !pos)
    return ERR_DTYPE;
  const uintptr_t cache_align = int8 ? 8 : 16;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(out)) % 16
      || (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v))
             % cache_align)
    return ERR_ALIGN;
  const int G = H / K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == DT_BF16) {
    if (int8)
      return launch_lpr<__nv_bfloat16, int8_t>(G, B, W, H, K, hd, n_split,
                                               pos64, scale, q, k, v, ks, vs,
                                               pos, part, out, st);
    return launch_lpr<__nv_bfloat16, __nv_bfloat16>(
        G, B, W, H, K, hd, n_split, pos64, scale, q, k, v, ks, vs, pos, part,
        out, st);
  }
  if (int8)
    return launch_lpr<float, int8_t>(G, B, W, H, K, hd, n_split, pos64,
                                     scale, q, k, v, ks, vs, pos, part, out,
                                     st);
  return launch_lpr<float, float>(G, B, W, H, K, hd, n_split, pos64, scale,
                                  q, k, v, ks, vs, pos, part, out, st);
}

const char* decode_attention_error(int code) {
  switch (code) {
    case ERR_SHAPE: return "need B, W, K >= 1 and H >= K";
    case ERR_GROUP: return "H must be a multiple of K, with H / K <= 8";
    case ERR_HEAD_DIM: return "head_dim must be a multiple of 8 in 8..256";
    case ERR_ALIGN:
      return "q and out must be 16-byte aligned, k and v 16-byte (int8: "
             "8-byte)";
    case ERR_DTYPE:
      return "q bfloat16 or float32; k, v of q's dtype, or int8 with both "
             "scales; pos given";
    case ERR_SPLITS:
      return "n_split must be ceil(W / 256), W at most 262,144 rows";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
