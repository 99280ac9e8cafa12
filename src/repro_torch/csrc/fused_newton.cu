// Fused Woodbury-Newton transient of a lattice, one warp per lane, for
// sm_90a.
//
// Replaces the Pallas kernel repro/kernels/batched_solve/fused.py
// (`fused_newton`, :59, body `_newton_kernel`, :37) together with the
// `lax.scan` over time steps that calls it (repro/core/spice/transient.py
// :386-395). One launch runs a topology group's whole transient: for each
// lane b and each step s = 0..T-1
//   0. Krhs = KCoh[b] @ v + Ksrc[s, b]  (the per-step rhs hoist);
//   then the complete fixed-length Newton loop of `newton.make_fused_iter`:
//   1. gather the device terminal voltages (index -1 = ground reads 0);
//   2. evaluate the EKV channel current and its three partials in the
//      conducting direction (va >= vb: hi = va; else hi = vb, sign flipped);
//   3. assemble the k x k capacitance matrix A = I + D S (k = 3 n_dev)
//      from two outer products per device;
//   4. solve it in closed form: a 3x3 adjugate for n_dev = 1, a block
//      Schur complement over two 3x3 adjugates for n_dev = 2;
//   5. apply the update unless the lane has already converged; a lane
//      converges when max|dv| < tol (every row's |dv| < tol; a NaN row does
//      not converge), and its update of that iteration is still applied. A converged lane leaves the loop, which gives the
//      same result as running it to the cap frozen;
//   6. vs[b, s] = v.
// The one-step entry (`fused_newton_launch`) is the same kernel with
// T = 1 and step 0 switched off at compile time: it takes Krhs itself.
//
// Layouts (row-major, contiguous, B lanes, T steps):
//   rhs: Ksrc (T,B,n) C, or Krhs (B,n) C for one step   kcoh (B,n,n) C
//   v0 (B,n) S   params (B,8,n_dev) S   ku (B,n,k) C   sb (B,n_dev,3,k) C
//   kpa/kpg (B,n,n_dev) C   vs (B,T,n) S
// S is the store type, C the compute type: (double,double) for "f64",
// (float,double) for "mixed", (float,float) for "f32".
//
// What bounds it: not bytes (a lane reads ~3 KB of constants once and
// ~100 bytes per step) and not the card's FP64 rate (~1e3 operations per
// lane and Newton iteration), but one dependent chain per lane: T steps
// of a few Newton iterations each, every iteration a serial run of FP64
// exp/log1p, divisions and a 6x6 solve. Launched once per step from
// Python (the earlier design, one thread per lane), that chain sat under
// 300 launches and ~9,000 host operations per group. The design:
//   - the time loop runs inside the kernel, so a group is one launch;
//   - a lane is a warp: node row i lives in thread i (n <= 32), in
//     registers, with its rows of KCoh, KU, KPa and KPg loaded once per
//     launch; the lane's Sb sits in shared memory; Ksrc[s+1] is fetched
//     while step s iterates;
//   - the work of one iteration is spread where that cuts the warp's
//     instruction stream: device d's channel on threads 2d (softplus and
//     sigmoid of a) and 2d+1 (of b), in the conducting direction only; the
//     nine divisions of each 3x3 inverse one per thread;
//   - values cross threads through a per-warp row of shared memory (node
//     voltages, t, the device results, the inverse entries), each stage
//     one __syncwarp; the k x k assembly and solve run redundantly in
//     every thread, so w needs no broadcast; convergence is a warp vote,
//     so the early exit is warp-uniform.
// Each value keeps the one-thread kernel's order of operations, so a step
// agrees with the plain torch version as before; only the KCoh @ v sum
// (ascending j) may differ from the torch einsum by an ulp.
//
// The softplus and sigmoid formulas are those of the plain torch version
// (max(x,0) + log1p(exp(-|x|)) and 1/(1+exp(-x))).

#include <cuda_runtime.h>

#include <cstddef>
#include <initializer_list>

namespace {

constexpr int N_MAX = 32;      // largest node count a lane may carry
constexpr int N_PARAMS = 8;    // pol, vt0, n, kp, lam, w, l, gg
constexpr int LANES = 4;       // lattice lanes (warps) per block
constexpr int BLOCK = 32 * LANES;
constexpr unsigned FULL = 0xffffffffu;
constexpr double PHI_T = 0.02585;

// argument errors, returned as negative codes
constexpr int ERR_N = -1;
constexpr int ERR_NDEV = -2;
constexpr int ERR_PRECISION = -3;
constexpr int ERR_TERMINAL = -4;
constexpr int ERR_BATCH = -5;

struct Terminals {     // node index of each device's (g, a, b), -1 = ground
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

// magnitude m(v_hi, v_lo) of the channel current and its partials, by a
// pair of threads: the one with half_b false takes the softplus and
// sigmoid of a, its partner (thread index ^ 1) those of b, and the two
// swap them by shuffle; both return the same results. Every thread of
// the warp must call it.
template <typename C>
__device__ __forceinline__ void mag_all(C pol, C vt0, C n, C kp, C lam, C l,
                                        C vg, C hi, C lo, bool half_b, C& m,
                                        C& dvg, C& dhi, C& dlo) {
  const C den = C(2) * n * C(PHI_T);
  const C i_s = C(2) * n * kp * (C(1) / fmax(l, C(1e-3))) * C(PHI_T * PHI_T);
  const bool is_n = pol > C(0);
  const C vds = hi - lo;
  const C vgs_on = is_n ? vg - lo : hi - vg;
  const C x = half_b ? (vgs_on - vt0 - n * vds) / den : (vgs_on - vt0) / den;
  const C sp = softplus(x);
  const C dl2 = C(2) * sp * sigmoid(x);
  const C sp_o = __shfl_xor_sync(FULL, sp, 1);
  const C dl2_o = __shfl_xor_sync(FULL, dl2, 1);
  const C sp_a = half_b ? sp_o : sp, sp_b = half_b ? sp : sp_o;
  const C dl2a = half_b ? dl2_o : dl2, dl2b = half_b ? dl2 : dl2_o;
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

// inv = M^-1 for a 3x3 M: column j of the adjugate is r_j. Every thread
// of the warp must call it; xs: the warp's 9 entries of shared memory
template <typename C>
__device__ __forceinline__ void inv3(const C (&M)[3][3], C (&inv)[3][3],
                                     C* xs) {
  C r[3][3];
  cross(M[1], M[2], r[0]);
  cross(M[2], M[0], r[1]);
  cross(M[0], M[1], r[2]);
  const C det = M[0][0] * r[0][0] + M[0][1] * r[0][1] + M[0][2] * r[0][2];
  // the nine divisions one per thread: thread e < 9 takes entry
  // e = 3 i + j, inv[i][j] = r[j][i] / det, and all read them back
  const int e = threadIdx.x % 32;
  C num = r[0][0];
#pragma unroll
  for (int q = 1; q < 9; ++q)
    if (e == q) num = r[q % 3][q / 3];
  if (e < 9) xs[e] = num / det;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) inv[i][j] = xs[3 * i + j];
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
                                            C (&w)[3 * ND], C* xs) {
  if constexpr (ND == 1) {
    C Ai[3][3];
    inv3(A, Ai, xs);
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
    inv3(P, Pi, xs);
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
    inv3(Tm, Ti, xs + 9);
    mv3(Ti, rhs, x2);
    mv3(X, x2, Xx);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      w[i] = y1[i] - Xx[i];
      w[i + 3] = x2[i];
    }
  }
}

// entry src of a warp's row in shared memory; src = -1 (ground) reads 0
template <typename C>
__device__ __forceinline__ C node(const C* xs, int src) {
  return src >= 0 ? xs[src] : C(0);
}

// entry d of a two-entry array without a dynamic index (d is 0 or 1)
__device__ __forceinline__ int of_device(const int (&x)[2], int d) {
  return d == 0 ? x[0] : x[1];
}

template <typename S, typename C, int ND, bool SCAN>
__global__ void __launch_bounds__(BLOCK)
fused_newton_kernel(const C* __restrict__ rhs, const C* __restrict__ kcoh,
                    const S* __restrict__ v0, const S* __restrict__ params,
                    const C* __restrict__ ku, const C* __restrict__ sb,
                    const C* __restrict__ kpa, const C* __restrict__ kpg,
                    S* __restrict__ vs, Terminals term, int B, int T, int n,
                    int iters, C tol) {
  constexpr int K = 3 * ND;
  constexpr int NS = ND * 3 * K;
  __shared__ C s_sb[LANES][NS];
  // per warp: node values (v, then t), device results, inverse entries
  __shared__ C s_row[LANES][2][32];
  __shared__ C s_dev[LANES][ND][5];
  __shared__ C s_inv[LANES][18];
  const int warp = threadIdx.x / 32, i = threadIdx.x % 32;
  const int lane = blockIdx.x * LANES + warp;
  if (lane >= B) return;               // the whole warp: warps sync alone
  const size_t ln = static_cast<size_t>(lane);
  const bool row = i < n;

  // the lane's constants, once per launch
  C* sbl = s_sb[warp];
  for (int e = i; e < NS; e += 32) sbl[e] = sb[ln * NS + e];
  const size_t r = ln * n + (row ? i : 0);     // this thread's row
  C kw[K], pa[ND], pg[ND];
#pragma unroll
  for (int c = 0; c < K; ++c) kw[c] = row ? ku[r * K + c] : C(0);
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    pa[d] = row ? kpa[r * ND + d] : C(0);
    pg[d] = row ? kpg[r * ND + d] : C(0);
  }
  C kc[SCAN ? N_MAX : 1];
  if constexpr (SCAN) {
#pragma unroll
    for (int j = 0; j < N_MAX; ++j)
      kc[j] = (row && j < n) ? kcoh[r * n + j] : C(0);
  }
  // threads 2d and 2d + 1 evaluate device d (the others repeat a device):
  // its parameters and terminals
  const int dd = (i >> 1) % ND;
  const bool half_b = i & 1;
  C p[N_PARAMS];
#pragma unroll
  for (int q = 0; q < N_PARAMS; ++q)
    p[q] = C(params[(ln * N_PARAMS + q) * ND + dd]);
  const int tg = of_device(term.g, dd), ta = of_device(term.a, dd),
            tb = of_device(term.b, dd);
  C gg_d[ND];                                  // gate-leak conductances
#pragma unroll
  for (int d = 0; d < ND; ++d) gg_d[d] = __shfl_sync(FULL, p[7], 2 * d);
  __syncwarp();

  S v = row ? v0[r] : S(0);
  const size_t step_stride = static_cast<size_t>(B) * n;
  const C* src = rhs + r;
  S* out = vs + ln * T * n + (row ? i : 0);
  C src_next = row ? src[0] : C(0);
  for (int s = 0; s < T; ++s) {
    C krhs = src_next;
    if (s + 1 < T) src_next = row ? src[(s + 1) * step_stride] : C(0);
    if constexpr (SCAN) {
      // Krhs = KCoh @ v + Ksrc[s], the sum over j ascending
      C* xs = s_row[warp][0];
      xs[i] = C(v);
      __syncwarp();
      C acc = C(0);
#pragma unroll
      for (int j = 0; j < N_MAX; ++j)
        if (j < n) acc += kc[j] * xs[j];
      krhs = acc + krhs;
      __syncwarp();                    // all have read xs before it changes
    }

    for (int it = 0; it < iters; ++it) {
      const C vc = C(v);
      C* xv = s_row[warp][0];
      xv[i] = vc;
      __syncwarp();
      // channel of device dd in its conducting direction
      const C vg = node(xv, tg), va = node(xv, ta), vb = node(xv, tb);
      const bool fwd = va >= vb;
      C m, m_vg, m_hi, m_lo;
      mag_all(p[0], p[1], p[2], p[3], p[4], p[6], vg, fwd ? va : vb,
              fwd ? vb : va, half_b, m, m_vg, m_hi, m_lo);
      const C wd = p[5];
      const C my_iab = wd * (fwd ? m : -m);
      const C my_d0 = wd * (fwd ? m_vg : -m_vg);
      const C my_d1 = wd * (fwd ? m_hi : -m_lo);
      const C my_d2 = wd * (fwd ? m_lo : -m_hi);
      const C my_ig = p[7] * (vg - C(0.5) * (va + vb));
      if (i < 2 * ND && !half_b) {
        C* res = s_dev[warp][dd];
        res[0] = my_iab;
        res[1] = my_ig;
        res[2] = my_d0;
        res[3] = my_d1;
        res[4] = my_d2;
      }
      __syncwarp();
      C i_ab[ND], i_g[ND], d3[ND][3];
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const C* res = s_dev[warp][d];
        i_ab[d] = res[0];
        i_g[d] = res[1];
        d3[d][0] = res[2];
        d3[d][1] = res[3];
        d3[d][2] = res[4];
      }

      // t = v - K rhs + (K Pa) i_ab + (K Pg) i_g, row i
      C sa = C(0), sg = C(0);
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        sa += pa[d] * i_ab[d];
        sg += pg[d] * i_g[d];
      }
      const C t = vc - krhs + sa + sg;
      C* xt = s_row[warp][1];
      xt[i] = t;
      __syncwarp();

      // A = I + D S and b = D (Vm t), rows (a, b, g) per device, in
      // every thread
      C A[K][K], bk[K], w[K];
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const C gg = gg_d[d];
        const C g3[3] = {node(xt, of_device(term.g, d)),
                         node(xt, of_device(term.a, d)),
                         node(xt, of_device(term.b, d))};
        const C* sd = sbl + d * 3 * K;
#pragma unroll
        for (int c = 0; c < K; ++c) {
          const C d3S = d3[d][0] * sd[c] + d3[d][1] * sd[K + c] + d3[d][2] * sd[2 * K + c];
          const C egS = (sd[c] - C(0.5) * sd[K + c] - C(0.5) * sd[2 * K + c]) * gg;
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
      solve_small<C, ND>(A, bk, w, s_inv[warp]);

      // dv = t - KU w; the lane is not converged yet, so the update applies
      C kwsum = C(0);
#pragma unroll
      for (int c = 0; c < K; ++c) kwsum += kw[c] * w[c];
      const C dv = t - kwsum;
      // converged: max|dv| < tol, i.e. every row's |dv| < tol (a NaN row
      // counts as not converged, as in the plain version's amax)
      const bool conv = __all_sync(FULL, !row || fabs(dv) < tol);
      if (row) v = S(vc - dv);
      if (conv) break;
    }
    if (row) out[static_cast<size_t>(s) * n] = v;
  }
}

template <typename S, typename C, bool SCAN>
int launch_typed(int n_dev, int B, int T, int n, int iters, double tol,
                 const void* rhs, const void* kcoh, const void* v0,
                 const void* params, const void* ku, const void* sb,
                 const void* kpa, const void* kpg, void* vs,
                 const Terminals& term, cudaStream_t stream) {
  const dim3 grid((B + LANES - 1) / LANES), block(BLOCK);
  const auto* rh = static_cast<const C*>(rhs);
  const auto* kc = static_cast<const C*>(kcoh);
  const auto* vi = static_cast<const S*>(v0);
  const auto* pr = static_cast<const S*>(params);
  const auto* u = static_cast<const C*>(ku);
  const auto* s = static_cast<const C*>(sb);
  const auto* pa = static_cast<const C*>(kpa);
  const auto* pg = static_cast<const C*>(kpg);
  auto* vo = static_cast<S*>(vs);
  if (n_dev == 1)
    fused_newton_kernel<S, C, 1, SCAN><<<grid, block, 0, stream>>>(
        rh, kc, vi, pr, u, s, pa, pg, vo, term, B, T, n, iters, C(tol));
  else
    fused_newton_kernel<S, C, 2, SCAN><<<grid, block, 0, stream>>>(
        rh, kc, vi, pr, u, s, pa, pg, vo, term, B, T, n, iters, C(tol));
  return static_cast<int>(cudaGetLastError());
}

template <bool SCAN>
int launch(int store_f64, int compute_f64, int n_dev, int B, int T, int n,
           int iters, double tol, const void* rhs, const void* kcoh,
           const void* v0, const void* params, const void* ku,
           const void* sb, const void* kpa, const void* kpg, void* vs,
           const int* terminals, void* stream) {
  if (n < 1 || n > N_MAX) return ERR_N;
  if (n_dev < 1 || n_dev > 2) return ERR_NDEV;
  if (B < 1 || T < 1 || iters < 0) return ERR_BATCH;
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
    return launch_typed<double, double, SCAN>(n_dev, B, T, n, iters, tol,
                                              rhs, kcoh, v0, params, ku, sb,
                                              kpa, kpg, vs, term, st);
  if (!store_f64 && compute_f64)
    return launch_typed<float, double, SCAN>(n_dev, B, T, n, iters, tol,
                                             rhs, kcoh, v0, params, ku, sb,
                                             kpa, kpg, vs, term, st);
  if (!store_f64 && !compute_f64)
    return launch_typed<float, float, SCAN>(n_dev, B, T, n, iters, tol, rhs,
                                            kcoh, v0, params, ku, sb, kpa,
                                            kpg, vs, term, st);
  return ERR_PRECISION;
}

}  // namespace

extern "C" {

// store_f64 / compute_f64: 1 for double, 0 for float. terminals: host
// array of 3 * n_dev node indices, (g..., a..., b...), -1 for ground.
// Each returns 0, a negative argument error, or the cudaError_t of the
// launch.

// One backward-Euler step's Newton solve: krhs (B,n) -> vout (B,n).
int fused_newton_launch(int store_f64, int compute_f64, int n_dev, int B,
                        int n, int iters, double tol, const void* krhs,
                        const void* v0, const void* params, const void* ku,
                        const void* sb, const void* kpa, const void* kpg,
                        void* vout, const int* terminals, void* stream) {
  return launch<false>(store_f64, compute_f64, n_dev, B, 1, n, iters, tol,
                       krhs, nullptr, v0, params, ku, sb, kpa, kpg, vout,
                       terminals, stream);
}

// T steps: ksrc (T,B,n), kcoh (B,n,n) -> vs (B,T,n).
int fused_newton_scan_launch(int store_f64, int compute_f64, int n_dev,
                             int B, int T, int n, int iters, double tol,
                             const void* ksrc, const void* kcoh,
                             const void* v0, const void* params,
                             const void* ku, const void* sb, const void* kpa,
                             const void* kpg, void* vs, const int* terminals,
                             void* stream) {
  return launch<true>(store_f64, compute_f64, n_dev, B, T, n, iters, tol,
                      ksrc, kcoh, v0, params, ku, sb, kpa, kpg, vs,
                      terminals, stream);
}

const char* fused_newton_error(int code) {
  switch (code) {
    case ERR_N: return "node count n outside 1..32";
    case ERR_NDEV: return "device count n_dev must be 1 or 2";
    case ERR_PRECISION: return "store type wider than compute type";
    case ERR_TERMINAL: return "terminal index outside -1..n-1";
    case ERR_BATCH: return "batch and steps must be >= 1 and iters >= 0";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
