// Batched unpivoted Gauss-Jordan solve J x = r, for sm_90a: one warp per
// system up to N = 32, one thread block per system above.
//
// Replaces the Pallas kernel repro/kernels/batched_solve/kernel.py
// (`batched_solve`, body `_gauss_jordan_kernel`). Both kernels compute
// what that kernel computes, in the same order:
//   1. load J and r, cast to float32;
//   2. for each pivot k: inv = 1/J[k,k]; factor_i = J[i,k]*inv, with row
//      k's factor 0; J[i,:] -= factor_i*J[k,:] (column k included) and
//      r[i] -= factor_i*r[k];
//   3. x = r/diag(J), written in r's type.
// No pivoting: the MNA Jacobian carries gmin + C/h + G_BIG diagonal
// stamps, so its diagonal dominates. The reference pads N to 128 with
// identity rows; pad columns stay zero in the real rows, so the real rows
// see the same arithmetic without the pad, and the kernels take N as is.
// Products and differences are rounded one by one (__fmul_rn/__fsub_rn,
// no FMA contraction), as the reference and the plain torch version
// round them, so kernel and plain version agree bit for bit.
//
// Layouts (row-major, contiguous): J (B,N,N) T, r (B,N) T, x (B,N) T,
// T float or double.
//
// What bounds it: one system reads (N*N + N)*sizeof(T) bytes, writes
// N*sizeof(T), and does about 2 N^3 float32 operations. At the transient
// path's N = 13 that is 1.5 KB and 4.4e3 operations (f64 input), far
// below one launch's latency: the N pivots run one after another, so a
// launch is bound by that serial chain, and a large batch by how many
// systems run side by side.
//
// Warp kernel (N <= 32, the transient path's N = 12-13): lane i holds
// row i of [J | r] in registers, W = 16 or 32 columns wide at compile
// time, so every loop unrolls and no index is divided; W = 16 packs two
// systems into a warp. At pivot k, lane k publishes its row in a
// per-system row of shared memory (two rows, used in turn, so one
// __syncwarp per pivot orders the writes and the reads); every lane of
// the system reads it back as a broadcast, takes the reciprocal of the
// pivot itself and updates its own row. (A variant in which lane k took
// the reciprocal once and published it with the row ran slower on the
// card: the division then sits between lane k's update and its
// publish.) No block barrier: WARPS warps of a block solve independent
// systems, so B = 4096 at N = 13 is 256 blocks.
//
// Block kernel (32 < N <= 240): J in shared memory, the factors of a
// pivot computed first, then the update by a row loop over the warps and
// a column loop over the lanes, with two block barriers per pivot.

#include <cuda_runtime.h>

namespace {

// -- warp kernel
constexpr int WARPS = 8;            // warps per block
constexpr int WARP_N_MAX = 32;

// -- block kernel
constexpr int MAX_THREADS = 256;
// (N*N + 2N) floats must fit the 227 KB of shared memory a block can use
constexpr int N_MAX = 240;
constexpr size_t SMEM_DEFAULT = 48 * 1024;

// argument errors, returned as negative codes
constexpr int ERR_N = -1;
constexpr int ERR_BATCH = -2;
constexpr int ERR_ROUTE = -3;

template <typename T, int W>
__global__ void __launch_bounds__(WARPS * 32)
gauss_jordan_warp_kernel(const T* __restrict__ J, const T* __restrict__ r,
                         T* __restrict__ x, int B, int N) {
  constexpr int SYS = 32 / W;           // systems per warp
  constexpr int LD = W + 4;             // W entries, r, pad
  __shared__ __align__(16) float pub[WARPS][SYS][2][LD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / W, i = lane % W;   // system of the warp, row
  const long long first = (static_cast<long long>(blockIdx.x) * WARPS +
                           warp) * SYS;
  if (first >= B) return;               // the whole warp is past the batch
  const long long b = first + sub;
  const bool real = b < B && i < N;     // pad lanes compute, never store

  float a[W];
  float rv = 0.0f;
  const T* jb = J + (real ? b * N * N + static_cast<long long>(i) * N : 0);
#pragma unroll
  for (int j = 0; j < W; ++j)
    a[j] = (real && j < N) ? static_cast<float>(jb[j]) : 0.0f;
  if (real) rv = static_cast<float>(r[b * N + i]);

#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (k >= N) break;
    float* row = pub[warp][sub][k & 1];
    if (i == k) {
#pragma unroll
      for (int j = 0; j < W; j += 4)
        *reinterpret_cast<float4*>(row + j) =
            make_float4(a[j], a[j + 1], a[j + 2], a[j + 3]);
      row[W] = rv;
    }
    __syncwarp();
    float p[W];
#pragma unroll
    for (int j = 0; j < W; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(row + j);
      p[j] = q.x; p[j + 1] = q.y; p[j + 2] = q.z; p[j + 3] = q.w;
    }
    const float inv = __fdiv_rn(1.0f, p[k]);
    // the factor is read before the update overwrites column k; row k's
    // factor is 0, and its update x - 0*x leaves it as it is, as in the
    // plain version
    const float fac = (i == k) ? 0.0f : __fmul_rn(a[k], inv);
#pragma unroll
    for (int j = 0; j < W; ++j) a[j] = __fsub_rn(a[j], __fmul_rn(fac, p[j]));
    rv = __fsub_rn(rv, __fmul_rn(fac, row[W]));
  }
  float diag = 0.0f;
#pragma unroll
  for (int j = 0; j < W; ++j)
    if (j == i) diag = a[j];
  if (real) x[b * N + i] = static_cast<T>(__fdiv_rn(rv, diag));
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
gauss_jordan_kernel(const T* __restrict__ J, const T* __restrict__ r,
                    T* __restrict__ x, int N) {
  extern __shared__ float smem[];
  float* a = smem;             // (N, N)
  float* rr = a + N * N;       // (N,)
  float* fac = rr + N;         // (N,) factors of the current pivot
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x, nn = N * N;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const T* jb = J + b * nn;
  const T* rb = r + b * N;
  for (int e = tid; e < nn; e += nt) a[e] = static_cast<float>(jb[e]);
  for (int i = tid; i < N; i += nt) rr[i] = static_cast<float>(rb[i]);
  __syncthreads();
  for (int k = 0; k < N; ++k) {
    // the factors are read before the update overwrites column k
    const float inv = __fdiv_rn(1.0f, a[k * N + k]);
    for (int i = tid; i < N; i += nt)
      fac[i] = (i == k) ? 0.0f : __fmul_rn(a[i * N + k], inv);
    __syncthreads();
    // row k (factor 0) is left as it is: x - 0*y == x
    const float* pivot_row = a + k * N;
    for (int i = warp; i < N; i += nw) {
      if (i == k) continue;
      const float f = fac[i];
      float* row = a + i * N;
      for (int j = lane; j < N; j += 32)
        row[j] = __fsub_rn(row[j], __fmul_rn(f, pivot_row[j]));
    }
    const float pr = rr[k];
    for (int i = tid; i < N; i += nt)
      if (i != k) rr[i] = __fsub_rn(rr[i], __fmul_rn(fac[i], pr));
    __syncthreads();
  }
  for (int i = tid; i < N; i += nt)
    x[b * N + i] = static_cast<T>(__fdiv_rn(rr[i], a[i * N + i]));
}

template <typename T>
int launch_warp(int B, int N, const void* J, const void* r, void* x,
                cudaStream_t stream) {
  const auto* Jt = static_cast<const T*>(J);
  const auto* rt = static_cast<const T*>(r);
  auto* xt = static_cast<T*>(x);
  if (N <= 16) {
    const int per_block = WARPS * 2;
    gauss_jordan_warp_kernel<T, 16><<<(B + per_block - 1) / per_block,
                                      WARPS * 32, 0, stream>>>(Jt, rt, xt,
                                                               B, N);
  } else {
    gauss_jordan_warp_kernel<T, 32><<<(B + WARPS - 1) / WARPS, WARPS * 32,
                                      0, stream>>>(Jt, rt, xt, B, N);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_block(int B, int N, const void* J, const void* r, void* x,
                 cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(N) * N + 2 * N) * sizeof(float);
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        gauss_jordan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = (N * N + 31) / 32 * 32;
  threads = threads > MAX_THREADS ? MAX_THREADS : threads;
  gauss_jordan_kernel<T><<<B, threads, smem, stream>>>(
      static_cast<const T*>(J), static_cast<const T*>(r), static_cast<T*>(x),
      N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The warp kernel, 1 <= N <= 32. is_f64: 1 when J, r and x are double,
// 0 when float. Returns 0, a negative argument error, or the cudaError_t
// of the launch.
int gauss_jordan_warp_launch(int is_f64, int B, int N, const void* J,
                             const void* r, void* x, void* stream) {
  if (N < 1 || N > WARP_N_MAX) return ERR_ROUTE;
  if (B < 1) return ERR_BATCH;
  auto st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_warp<double>(B, N, J, r, x, st)
                : launch_warp<float>(B, N, J, r, x, st);
}

// The block kernel, 32 < N <= 240; arguments and result as above.
int gauss_jordan_block_launch(int is_f64, int B, int N, const void* J,
                              const void* r, void* x, void* stream) {
  if (N < 1 || N > N_MAX) return ERR_N;
  if (N <= WARP_N_MAX) return ERR_ROUTE;
  if (B < 1) return ERR_BATCH;
  auto st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_block<double>(B, N, J, r, x, st)
                : launch_block<float>(B, N, J, r, x, st);
}

const char* gauss_jordan_error(int code) {
  switch (code) {
    case ERR_N: return "system size N outside 1..240";
    case ERR_BATCH: return "batch must be >= 1";
    case ERR_ROUTE:
      return "N <= 32 goes to the warp kernel, 32 < N <= 240 to the block "
             "kernel";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
