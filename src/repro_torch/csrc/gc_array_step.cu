// One implicit (backward-Euler) step of an R x C gain-cell array with
// bitline-rail coupling, for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/gc_array_step/kernel.py
// (`gc_array_step`, bodies `_kernel` and `_step_math`). Cells couple only
// through their column's read bitline, so columns are independent given
// their rail. GS_SWEEPS Gauss-Seidel sweeps of:
//   1. for every row: NEWTON Newton iterations on the storage node with a
//      finite-difference derivative (step DV), the rail frozen;
//   2. the column's read current and its finite-difference conductance
//      to the rail (step DV), summed over the rows, then the linearized
//      rail KCL.
// DV is 1e-4 for both, as in the Pallas kernel; the reference's oracle
// (ref.py) takes 1e-3 for the rail conductance.
//
// Work split: a block holds up to 32 columns (threadIdx.x; fewer when
// block_c is smaller) and up to 32 row groups (threadIdx.y, `ty`); thread
// (x, y) owns column x and rows y, y + ty, y + 2 ty, ... The storage-node Newton is per cell, so the row groups
// run it in parallel; the column sums are taken per row group in row
// order, then over the groups in group order in shared memory, by the
// group-0 thread, which also updates the rail. The order is fixed, so
// the result does not change from run to run.
//
// All float32, as the Pallas kernel; the 16 device and rail parameters
// arrive by value. Every product that feeds a sum is an __fmul_rn, so nvcc
// cannot contract it into an FMA and products and sums round one by one
// as in the plain torch version; the two then differ only by
// expf/log1pf and by the order of the column sums.
//
// Layouts (row-major, contiguous float32): v_sn (R,C), v_bl (C,), wwl
// (R,), wbl (C,), rwl (R,); out_sn (R,C), out_bl (C,). The storage-node
// iterates live in out_sn between the sweeps; neighbouring threads touch
// neighbouring columns, so every row access is coalesced.
//
// What bounds it: per cell it reads and writes 8 bytes and evaluates the
// channel model 16 times (about 680 float32 operations with expf and
// log1pf, each a dependent chain), so it is bound by operations and, at
// a few hundred columns, by how few blocks there are to spread over the
// 132 SMs.

#include <cuda_runtime.h>

// the 16 parameters, passed by value through the C interface (outside the
// anonymous namespace, so the exported launcher keeps external linkage)
struct GcParams {
  float vtw, nw, kpw, lamw, ww, lw;
  float vtr, nr, kpr, lamr, wr, lr;
  float c_sn, c_bl, g_bl, v_bl_drv;
};

namespace {

constexpr int NEWTON = 3;
constexpr int GS_SWEEPS = 2;
constexpr float DV = 1e-4f;
constexpr float PHI_T = 0.02585f;
constexpr float PHI_T2 = static_cast<float>(0.02585 * 0.02585);
constexpr int MAX_THREADS = 1024;
constexpr int MAX_COLS = 32;       // columns per block
constexpr int ROW_GROUPS = 32;     // threads sharing one column's rows

constexpr int ERR_SHAPE = -1;
constexpr int ERR_BLOCK = -2;

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// NMOS channel-current magnitude hi -> lo (mna.channel_current_raw, pol 1)
__device__ __forceinline__ float mag(float vt0, float n, float kp, float lam,
                                     float l, float vg, float hi, float lo) {
  const float vds = hi - lo;
  const float vgs_on = vg - lo;
  const float i_s = 2.0f * n * kp * (1.0f / fmaxf(l, 1e-3f)) * PHI_T2;
  const float den = 2.0f * n * PHI_T;
  const float a = (vgs_on - vt0) / den;
  const float b = (vgs_on - vt0 - __fmul_rn(n, vds)) / den;
  const float sa = softplus(a), sb = softplus(b);
  return i_s * (__fmul_rn(sa, sa) - __fmul_rn(sb, sb)) *
         (1.0f + __fmul_rn(lam, vds));
}

// signed current a -> b
__device__ __forceinline__ float channel(float vt0, float n, float kp,
                                         float lam, float w, float l, float vg,
                                         float va, float vb) {
  // the caller adds the result to a sum
  return __fmul_rn(w, va >= vb ? mag(vt0, n, kp, lam, l, vg, va, vb)
                               : -mag(vt0, n, kp, lam, l, vg, vb, va));
}

__global__ void __launch_bounds__(MAX_THREADS)
gc_array_step_kernel(const float* __restrict__ v_sn,
                     const float* __restrict__ v_bl,
                     const float* __restrict__ wwl,
                     const float* __restrict__ wbl,
                     const float* __restrict__ rwl, const GcParams p,
                     const float h, float* __restrict__ out_sn,
                     float* __restrict__ out_bl, int R, int C) {
  extern __shared__ float smem[];
  const int bx = blockDim.x, ty = blockDim.y;
  const int x = threadIdx.x, y = threadIdx.y;
  float* part = smem;                  // (ty, bx) partial i_col
  float* part2 = part + ty * bx;       // (ty, bx) partial i_col at vbl + DV
  float* rail = part2 + ty * bx;       // (bx,) the rail after each sweep
  const int c = blockIdx.x * bx + x;
  const bool active = c < C;           // inactive threads still sync
  const float wbl_c = active ? wbl[c] : 0.0f;
  const float vbl_prev = active ? v_bl[c] : 0.0f;
  if (y == 0) rail[x] = vbl_prev;
  __syncthreads();
  for (int sweep = 0; sweep < GS_SWEEPS; ++sweep) {
    const float vbl = rail[x];
    const float vbl2 = vbl + DV;
    float i_col = 0.0f, i_col2 = 0.0f;
    for (int r = y; active && r < R; r += ty) {
      // storage node, rail frozen: write device gate=WWL, SN <-> WBL
      const size_t e = static_cast<size_t>(r) * C + c;
      const float prev = v_sn[e];
      const float g = wwl[r];
      float vs = sweep == 0 ? prev : out_sn[e];
      for (int it = 0; it < NEWTON; ++it) {
        const float vs2 = vs + DV;
        const float res = p.c_sn * (vs - prev) / h +
                          channel(p.vtw, p.nw, p.kpw, p.lamw, p.ww, p.lw, g,
                                  vs, wbl_c);
        const float res2 = p.c_sn * (vs2 - prev) / h +
                           channel(p.vtw, p.nw, p.kpw, p.lamw, p.ww, p.lw, g,
                                   vs2, wbl_c);
        const float dr = (res2 - res) / DV;
        vs = vs - res / fmaxf(dr, 1e-18f);
      }
      out_sn[e] = vs;
      // rail: read device gate=SN, channel RBL <-> RWL
      i_col += channel(p.vtr, p.nr, p.kpr, p.lamr, p.wr, p.lr, vs, vbl,
                       rwl[r]);
      i_col2 += channel(p.vtr, p.nr, p.kpr, p.lamr, p.wr, p.lr, vs, vbl2,
                        rwl[r]);
    }
    part[y * bx + x] = i_col;
    part2[y * bx + x] = i_col2;
    __syncthreads();
    if (y == 0) {
      float sum = 0.0f, sum2 = 0.0f;
      for (int k = 0; k < ty; ++k) {
        sum += part[k * bx + x];
        sum2 += part2[k * bx + x];
      }
      const float g_cells = (sum2 - sum) / DV;
      const float num = __fmul_rn(p.c_bl / h, vbl_prev) +
                        __fmul_rn(p.g_bl, p.v_bl_drv) -
                        (sum - __fmul_rn(g_cells, vbl));
      const float den = p.c_bl / h + p.g_bl + g_cells;
      rail[x] = num / den;
    }
    __syncthreads();
  }
  if (active && y == 0) out_bl[c] = rail[x];
}

}  // namespace

extern "C" {

// block_c: columns per block, capped at MAX_COLS. Returns 0, a negative argument
// error, or the cudaError_t of the launch.
int gc_array_step_launch(int R, int C, int block_c, const float* v_sn,
                         const float* v_bl, const float* wwl, const float* wbl,
                         const float* rwl, GcParams p, float h, float* out_sn,
                         float* out_bl, void* stream) {
  if (R < 1 || C < 1) return ERR_SHAPE;
  if (block_c < 1 || block_c > MAX_THREADS) return ERR_BLOCK;
  // columns per block: block_c, at most a warp's width, so that a few
  // hundred columns still spread over several SMs; the rest of the block
  // goes to row groups
  int bx = block_c < C ? block_c : C;
  bx = bx > MAX_COLS ? MAX_COLS : bx;
  int ty = MAX_THREADS / bx;
  ty = ty > ROW_GROUPS ? ROW_GROUPS : ty;
  ty = ty > R ? R : ty;
  const dim3 block(bx, ty), grid((C + bx - 1) / bx);
  const size_t smem = (2 * static_cast<size_t>(ty) + 1) * bx * sizeof(float);
  gc_array_step_kernel<<<grid, block, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      v_sn, v_bl, wwl, wbl, rwl, p, h, out_sn, out_bl, R, C);
  return static_cast<int>(cudaGetLastError());
}

const char* gc_array_step_error(int code) {
  switch (code) {
    case ERR_SHAPE: return "array must have R >= 1 rows and C >= 1 columns";
    case ERR_BLOCK: return "block_c outside 1..1024";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
