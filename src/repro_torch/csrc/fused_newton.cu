// Fused Woodbury-Newton solve of one backward-Euler timestep, one CUDA
// thread per lattice lane, for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/batched_solve/fused.py
// (`fused_newton`, body `_newton_kernel`). For every lane it runs the
// complete fixed-length Newton loop of `newton.make_fused_iter`:
//   1. gather the device terminal voltages (index -1 = ground reads 0);
//   2. evaluate the EKV channel current and its three partials once;
//   3. assemble the k x k capacitance matrix A = I + D S (k = 3 n_dev)
//      from two outer products per device;
//   4. solve it in closed form: a 3x3 adjugate for n_dev = 1, a block
//      Schur complement over two 3x3 adjugates for n_dev = 2;
//   5. apply the update unless the lane has already converged; a lane
//      converges when max|dv| < tol, and its update of that iteration is
//      still applied. A converged lane leaves the loop, which gives the
//      same result as running it to the cap frozen.
//
// Layouts (row-major, contiguous, B lanes):
//   krhs (B,n) C   v0 (B,n) S   params (B,8,n_dev) S   ku (B,n,k) C
//   sb (B,n_dev,3,k) C   kpa/kpg (B,n,n_dev) C   vout (B,n) S
// S is the store type, C the compute type: (double,double) for "f64",
// (float,double) for "mixed", (float,float) for "f32".
//
// What bounds it: per lane it reads about 1.7 KB (n = 13, n_dev = 2 at
// f64) and does about 1e3 FP64 operations per Newton iteration. At the
// main path's B = 16 lanes that is far below the latency of one launch,
// so the transient loop is launch-bound: 300 launches per topology
// group. The design does nothing about that yet: fusing the 300-step
// loop into the kernel, or capturing it in a CUDA graph, is later work.
// Within a launch the per-lane operands stay in L1 across iterations
// (read-only loads), and the state lives in registers/local memory.
//
// The softplus and sigmoid formulas are those of the plain torch version
// (max(x,0) + log1p(exp(-|x|)) and 1/(1+exp(-x))).

#include <cuda_runtime.h>

#include <initializer_list>

namespace {

constexpr int N_MAX = 32;      // largest node count a lane may carry
constexpr int N_PARAMS = 8;    // pol, vt0, n, kp, lam, w, l, gg
constexpr int BLOCK = 128;
constexpr double PHI_T = 0.02585;

// argument errors, returned as negative codes
constexpr int ERR_N = -1;
constexpr int ERR_NDEV = -2;
constexpr int ERR_PRECISION = -3;
constexpr int ERR_TERMINAL = -4;
constexpr int ERR_BATCH = -5;

struct Terminals {
  int g[2], a[2], b[2];
};

template <typename C>
__device__ __forceinline__ C softplus(C x) {
  return fmax(x, C(0)) + log1p(exp(-fabs(x)));
}

template <typename C>
__device__ __forceinline__ C sigmoid(C x) {
  return C(1) / (C(1) + exp(-x));
}

// magnitude m(v_hi, v_lo) of the channel current and its partials
template <typename C>
__device__ __forceinline__ void mag_all(C pol, C vt0, C n, C kp, C lam, C l,
                                        C vg, C hi, C lo, C& m, C& dvg,
                                        C& dhi, C& dlo) {
  const C den = C(2) * n * C(PHI_T);
  const C i_s = C(2) * n * kp * (C(1) / fmax(l, C(1e-3))) * C(PHI_T * PHI_T);
  const bool is_n = pol > C(0);
  const C vds = hi - lo;
  const C vgs_on = is_n ? vg - lo : hi - vg;
  const C a = (vgs_on - vt0) / den;
  const C b = (vgs_on - vt0 - n * vds) / den;
  const C sp_a = softplus(a), sp_b = softplus(b);
  const C dl2a = C(2) * sp_a * sigmoid(a);
  const C dl2b = C(2) * sp_b * sigmoid(b);
  const C core = sp_a * sp_a - sp_b * sp_b;
  const C lam_f = C(1) + lam * vds;
  const C s_vg = is_n ? C(1) : C(-1);
  const C s_hi = is_n ? C(0) : C(1);
  const C s_lo = is_n ? C(-1) : C(0);
  m = i_s * core * lam_f;
  dvg = i_s * (dl2a - dl2b) * s_vg / den * lam_f;
  dhi = i_s * ((dl2a * s_hi - dl2b * (s_hi - n)) / den * lam_f + core * lam);
  dlo = i_s * ((dl2a * s_lo - dl2b * (s_lo + n)) / den * lam_f - core * lam);
}

template <typename C>
__device__ __forceinline__ void cross(const C* a, const C* b, C* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// inv = M^-1 for a 3x3 M: column j of the adjugate is r_j
template <typename C>
__device__ __forceinline__ void inv3(const C (&M)[3][3], C (&inv)[3][3]) {
  C r[3][3];
  cross(M[1], M[2], r[0]);
  cross(M[2], M[0], r[1]);
  cross(M[0], M[1], r[2]);
  const C det = M[0][0] * r[0][0] + M[0][1] * r[0][1] + M[0][2] * r[0][2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) inv[i][j] = r[j][i] / det;
}

template <typename C>
__device__ __forceinline__ void mv3(const C (&M)[3][3], const C* x, C* y) {
#pragma unroll
  for (int i = 0; i < 3; ++i) y[i] = M[i][0] * x[0] + M[i][1] * x[1] + M[i][2] * x[2];
}

// w = A^-1 b for the k x k capacitance matrix, k = 3 ND
template <typename C, int ND>
__device__ __forceinline__ void solve_small(const C (&A)[3 * ND][3 * ND],
                                            const C (&b)[3 * ND],
                                            C (&w)[3 * ND]) {
  if constexpr (ND == 1) {
    C Ai[3][3];
    inv3(A, Ai);
    mv3(Ai, b, w);
  } else {
    C P[3][3], Q[3][3], R[3][3], T[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        P[i][j] = A[i][j];
        Q[i][j] = A[i][j + 3];
        R[i][j] = A[i + 3][j];
        T[i][j] = A[i + 3][j + 3];
      }
    C Pi[3][3], X[3][3], y1[3];
    inv3(P, Pi);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        X[i][j] = Pi[i][0] * Q[0][j] + Pi[i][1] * Q[1][j] + Pi[i][2] * Q[2][j];
    mv3(Pi, b, y1);
    C Tm[3][3], Ry[3], rhs[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        Tm[i][j] = T[i][j] - (R[i][0] * X[0][j] + R[i][1] * X[1][j] + R[i][2] * X[2][j]);
    mv3(R, y1, Ry);
#pragma unroll
    for (int i = 0; i < 3; ++i) rhs[i] = b[i + 3] - Ry[i];
    C Ti[3][3], x2[3], Xx[3];
    inv3(Tm, Ti);
    mv3(Ti, rhs, x2);
    mv3(X, x2, Xx);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      w[i] = y1[i] - Xx[i];
      w[i + 3] = x2[i];
    }
  }
}

template <typename C>
__device__ __forceinline__ C pick(const C* x, int idx) {
  return idx >= 0 ? x[idx] : C(0);
}

template <typename S, typename C, int ND>
__global__ void __launch_bounds__(BLOCK)
fused_newton_kernel(const C* __restrict__ krhs, const S* __restrict__ v0,
                    const S* __restrict__ params, const C* __restrict__ ku,
                    const C* __restrict__ sb, const C* __restrict__ kpa,
                    const C* __restrict__ kpg, S* __restrict__ vout,
                    Terminals term, int B, int n, int iters, C tol) {
  constexpr int K = 3 * ND;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t ln = static_cast<size_t>(lane);
  krhs += ln * n;
  v0 += ln * n;
  params += ln * N_PARAMS * ND;
  ku += ln * n * K;
  sb += ln * ND * 3 * K;
  kpa += ln * n * ND;
  kpg += ln * n * ND;
  vout += ln * n;

  S v[N_MAX];
  for (int i = 0; i < n; ++i) v[i] = v0[i];
  C p[N_PARAMS][ND];
#pragma unroll
  for (int r = 0; r < N_PARAMS; ++r)
#pragma unroll
    for (int d = 0; d < ND; ++d) p[r][d] = C(params[r * ND + d]);

  for (int it = 0; it < iters; ++it) {
    C vc[N_MAX], t[N_MAX];
    for (int i = 0; i < n; ++i) vc[i] = C(v[i]);

    C i_ab[ND], i_g[ND], d3[ND][3];
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const C vg = pick(vc, term.g[d]);
      const C va = pick(vc, term.a[d]);
      const C vb = pick(vc, term.b[d]);
      C f_m, f_dvg, f_dhi, f_dlo, r_m, r_dvg, r_dhi, r_dlo;
      mag_all(p[0][d], p[1][d], p[2][d], p[3][d], p[4][d], p[6][d], vg, va,
              vb, f_m, f_dvg, f_dhi, f_dlo);
      mag_all(p[0][d], p[1][d], p[2][d], p[3][d], p[4][d], p[6][d], vg, vb,
              va, r_m, r_dvg, r_dhi, r_dlo);
      const bool fwd = va >= vb;
      const C w = p[5][d];
      i_ab[d] = w * (fwd ? f_m : -r_m);
      d3[d][0] = w * (fwd ? f_dvg : -r_dvg);
      d3[d][1] = w * (fwd ? f_dhi : -r_dlo);
      d3[d][2] = w * (fwd ? f_dlo : -r_dhi);
      i_g[d] = p[7][d] * (vg - C(0.5) * (va + vb));
    }

    // t = v - K rhs + (K Pa) i_ab + (K Pg) i_g
    for (int i = 0; i < n; ++i) {
      C sa = C(0), sg = C(0);
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        sa += kpa[i * ND + d] * i_ab[d];
        sg += kpg[i * ND + d] * i_g[d];
      }
      t[i] = vc[i] - krhs[i] + sa + sg;
    }

    // A = I + D S and b = D (Vm t), rows (a, b, g) per device
    C A[K][K], bk[K], w[K];
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const C gg = p[7][d];
      const C g3[3] = {pick(t, term.g[d]), pick(t, term.a[d]),
                       pick(t, term.b[d])};
      const C* s = sb + d * 3 * K;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const C d3S = d3[d][0] * s[c] + d3[d][1] * s[K + c] + d3[d][2] * s[2 * K + c];
        const C egS = (s[c] - C(0.5) * s[K + c] - C(0.5) * s[2 * K + c]) * gg;
        A[3 * d][c] = C(3 * d == c) + (d3S - C(0.5) * egS);
        A[3 * d + 1][c] = C(3 * d + 1 == c) + (-d3S - C(0.5) * egS);
        A[3 * d + 2][c] = C(3 * d + 2 == c) + egS;
      }
      const C d3g = d3[d][0] * g3[0] + d3[d][1] * g3[1] + d3[d][2] * g3[2];
      const C egg = (g3[0] - C(0.5) * g3[1] - C(0.5) * g3[2]) * gg;
      bk[3 * d] = d3g - C(0.5) * egg;
      bk[3 * d + 1] = -d3g - C(0.5) * egg;
      bk[3 * d + 2] = egg;
    }
    solve_small<C, ND>(A, bk, w);

    // dv = t - KU w; the lane is not converged yet, so the update applies
    C dv_max = C(0);
    for (int i = 0; i < n; ++i) {
      C kw = C(0);
#pragma unroll
      for (int c = 0; c < K; ++c) kw += ku[i * K + c] * w[c];
      const C dv = t[i] - kw;
      dv_max = fmax(dv_max, fabs(dv));
      v[i] = S(vc[i] - dv);
    }
    if (dv_max < tol) break;
  }
  for (int i = 0; i < n; ++i) vout[i] = v[i];
}

template <typename S, typename C>
int launch_typed(int n_dev, int B, int n, int iters, double tol,
                 const void* krhs, const void* v0, const void* params,
                 const void* ku, const void* sb, const void* kpa,
                 const void* kpg, void* vout, const Terminals& term,
                 cudaStream_t stream) {
  const dim3 grid((B + BLOCK - 1) / BLOCK), block(BLOCK);
  const auto* kr = static_cast<const C*>(krhs);
  const auto* vi = static_cast<const S*>(v0);
  const auto* pr = static_cast<const S*>(params);
  const auto* u = static_cast<const C*>(ku);
  const auto* s = static_cast<const C*>(sb);
  const auto* pa = static_cast<const C*>(kpa);
  const auto* pg = static_cast<const C*>(kpg);
  auto* vo = static_cast<S*>(vout);
  if (n_dev == 1)
    fused_newton_kernel<S, C, 1><<<grid, block, 0, stream>>>(
        kr, vi, pr, u, s, pa, pg, vo, term, B, n, iters, C(tol));
  else
    fused_newton_kernel<S, C, 2><<<grid, block, 0, stream>>>(
        kr, vi, pr, u, s, pa, pg, vo, term, B, n, iters, C(tol));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// store_f64 / compute_f64: 1 for double, 0 for float. terminals: host
// array of 3 * n_dev node indices, (g..., a..., b...), -1 for ground.
// Returns 0, a negative argument error, or the cudaError_t of the launch.
int fused_newton_launch(int store_f64, int compute_f64, int n_dev, int B,
                        int n, int iters, double tol, const void* krhs,
                        const void* v0, const void* params, const void* ku,
                        const void* sb, const void* kpa, const void* kpg,
                        void* vout, const int* terminals, void* stream) {
  if (n < 1 || n > N_MAX) return ERR_N;
  if (n_dev < 1 || n_dev > 2) return ERR_NDEV;
  if (B < 1 || iters < 0) return ERR_BATCH;
  Terminals term{};
  for (int d = 0; d < n_dev; ++d) {
    term.g[d] = terminals[d];
    term.a[d] = terminals[n_dev + d];
    term.b[d] = terminals[2 * n_dev + d];
    for (int idx : {term.g[d], term.a[d], term.b[d]})
      if (idx < -1 || idx >= n) return ERR_TERMINAL;
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (store_f64 && compute_f64)
    return launch_typed<double, double>(n_dev, B, n, iters, tol, krhs, v0,
                                        params, ku, sb, kpa, kpg, vout, term, st);
  if (!store_f64 && compute_f64)
    return launch_typed<float, double>(n_dev, B, n, iters, tol, krhs, v0,
                                       params, ku, sb, kpa, kpg, vout, term, st);
  if (!store_f64 && !compute_f64)
    return launch_typed<float, float>(n_dev, B, n, iters, tol, krhs, v0,
                                      params, ku, sb, kpa, kpg, vout, term, st);
  return ERR_PRECISION;
}

const char* fused_newton_error(int code) {
  switch (code) {
    case ERR_N: return "node count n outside 1..32";
    case ERR_NDEV: return "device count n_dev must be 1 or 2";
    case ERR_PRECISION: return "store type wider than compute type";
    case ERR_TERMINAL: return "terminal index outside -1..n-1";
    case ERR_BATCH: return "batch must be >= 1 and iters >= 0";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
