// Batched unpivoted Gauss-Jordan solve J x = r, one thread block per
// system, for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/batched_solve/kernel.py
// (`batched_solve`, body `_gauss_jordan_kernel`). It computes what that
// kernel computes, in the same order:
//   1. load J and r, cast to float32;
//   2. for each pivot k: inv = 1/J[k,k]; factor_i = J[i,k]*inv, with row
//      k's factor 0; J[i,:] -= factor_i*J[k,:] (column k included) and
//      r[i] -= factor_i*r[k];
//   3. x = r/diag(J), written in r's type.
// No pivoting: the MNA Jacobian carries gmin + C/h + G_BIG diagonal
// stamps, so its diagonal dominates. The reference pads N to 128 with
// identity rows; pad columns stay zero in the real rows, so the real rows
// see the same arithmetic without the pad, and the kernel takes N as is.
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
// below one launch's latency, and the N pivots run one after another
// with two block barriers each: a launch is bound by that serial chain.
// J stays in shared memory for the whole elimination, so each input is
// read from device memory once. Large batches fill the card with one
// block per system.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 256;
// (N*N + 2N) floats must fit the 227 KB of shared memory a block can use
constexpr int N_MAX = 240;
constexpr size_t SMEM_DEFAULT = 48 * 1024;

// argument errors, returned as negative codes
constexpr int ERR_N = -1;
constexpr int ERR_BATCH = -2;

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
    for (int e = tid; e < nn; e += nt) {
      const int i = e / N;
      if (i != k)
        a[e] = __fsub_rn(a[e], __fmul_rn(fac[i], pivot_row[e - i * N]));
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
int launch_typed(int B, int N, const void* J, const void* r, void* x,
                 cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(N) * N + 2 * N) * sizeof(float);
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        gauss_jordan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = (N * N + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > MAX_THREADS ? MAX_THREADS : threads);
  gauss_jordan_kernel<T><<<B, threads, smem, stream>>>(
      static_cast<const T*>(J), static_cast<const T*>(r), static_cast<T*>(x),
      N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gauss_jordan_n_max() { return N_MAX; }

// is_f64: 1 when J, r and x are double, 0 when float.
// Returns 0, a negative argument error, or the cudaError_t of the launch.
int gauss_jordan_launch(int is_f64, int B, int N, const void* J,
                        const void* r, void* x, void* stream) {
  if (N < 1 || N > N_MAX) return ERR_N;
  if (B < 1) return ERR_BATCH;
  auto st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_typed<double>(B, N, J, r, x, st)
                : launch_typed<float>(B, N, J, r, x, st);
}

const char* gauss_jordan_error(int code) {
  switch (code) {
    case ERR_N: return "system size N outside 1..240";
    case ERR_BATCH: return "batch must be >= 1";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
