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
// Work split, chosen by the caller (kernel.py `geometry`) so that the
// grid covers every SM: a block holds `bx` columns (threadIdx.x, 2 to 8
// of them at the array sizes of the paths) and `ty` row groups
// (threadIdx.y); a thread-block cluster of `cs` blocks (1 to 8) shares
// one column block's rows. Thread (x, y) of cluster rank q owns column x
// of its column block and rows g, g + G, g + 2G, ... with g = q*ty + y
// and G = cs*ty. The storage-node Newton is per cell, so every row group
// runs it in parallel. The column sums are taken in a fixed order: per
// thread in row order, then a tree over the block's row groups in shared
// memory, then over the cluster's ranks in rank order, each block
// reading the others' block sums through distributed shared memory. Every
// block of a cluster so computes the same rail, bit for bit, and the
// output does not change from launch to launch. cluster.sync() comes
// before each rail update (every rank's block sum is ready) and after it
// (no rank rewrites its sums, or exits, while another still reads them).
// One launch, two Gauss-Seidel sweeps, no atomics, no grid-wide sync.
//
// All float32, as the Pallas kernel; the 16 device and rail parameters
// arrive by value. Every product that feeds a sum is an __fmul_rn, so nvcc
// cannot contract it into an FMA and products and sums round one by one
// as in the plain torch version; the two then differ only by
// expf/log1pf and by the order of the column sums.
//
// Layouts (row-major, contiguous float32): v_sn (R,C), v_bl (C,), wwl
// (R,), wbl (C,), rwl (R,); out_sn (R,C), out_bl (C,). The storage-node
// iterates live in out_sn between the sweeps. A warp touches bx
// neighbouring columns of 32/bx rows: short row segments, which cost
// little, since one step moves 2.1 MB at 512x512 (~0.6 us of HBM time).
//
// What bounds it: per cell it reads and writes 8 bytes and evaluates the
// channel model 16 times (about 680 float32 operations with 32 expf and
// 32 log1pf, each evaluation a dependent chain), so it is bound by
// operations and, where the array has few cells per SM, by the length
// of one thread's chain.

#include <cooperative_groups.h>
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
constexpr int MAX_CLUSTER = 8;     // the portable cluster size

constexpr int ERR_SHAPE = -1;
constexpr int ERR_GEOMETRY = -2;

namespace cg = cooperative_groups;

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
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int bx = blockDim.x, ty = blockDim.y;
  const int x = threadIdx.x, y = threadIdx.y;
  float* part = smem;                  // (ty, bx) partial i_col
  float* part2 = part + ty * bx;       // (ty, bx) partial i_col at vbl + DV
  float* rail = part2 + ty * bx;       // (bx,) the rail after each sweep
  const int c = (blockIdx.x / cs) * bx + x;
  const bool active = c < C;           // inactive threads still sync
  const int G = cs * ty;               // row groups of one column
  const float wbl_c = active ? wbl[c] : 0.0f;
  const float vbl_prev = active ? v_bl[c] : 0.0f;
  int half = 1;                        // the tree's first stride
  while (2 * half < ty) half *= 2;
  if (y == 0) rail[x] = vbl_prev;
  __syncthreads();
  for (int sweep = 0; sweep < GS_SWEEPS; ++sweep) {
    const float vbl = rail[x];
    const float vbl2 = vbl + DV;
    float i_col = 0.0f, i_col2 = 0.0f;
    for (int r = rank * ty + y; active && r < R; r += G) {
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
    // the block's row groups: a tree in shared memory, fixed order
    for (int s = half; s > 0; s >>= 1) {
      if (y < s && y + s < ty) {
        part[y * bx + x] += part[(y + s) * bx + x];
        part2[y * bx + x] += part2[(y + s) * bx + x];
      }
      __syncthreads();
    }
    cluster.sync();                    // every rank's block sum is ready
    if (y == 0) {
      // the cluster's ranks in rank order; every block sums alike
      float sum = 0.0f, sum2 = 0.0f;
      for (int q = 0; q < cs; ++q) {
        const float* remote = cluster.map_shared_rank(part, q);
        sum += remote[x];
        sum2 += remote[ty * bx + x];
      }
      const float g_cells = (sum2 - sum) / DV;
      const float num = __fmul_rn(p.c_bl / h, vbl_prev) +
                        __fmul_rn(p.g_bl, p.v_bl_drv) -
                        (sum - __fmul_rn(g_cells, vbl));
      const float den = p.c_bl / h + p.g_bl + g_cells;
      rail[x] = num / den;
    }
    // the rail is visible to the block, and no rank rewrites (or leaves)
    // its sums while another still reads them
    cluster.sync();
  }
  if (active && y == 0 && rank == 0) out_bl[c] = rail[x];
}

}  // namespace

extern "C" {

// One launch of ceil(C / bx) * cs blocks of (bx, ty) threads in clusters
// of cs blocks (kernel.py `geometry` chooses them). Returns 0, a negative
// argument error, or the cudaError_t of the launch; a cluster launch the
// card refuses is an error, never a smaller launch.
int gc_array_step_launch(int R, int C, int bx, int ty, int cs,
                         const float* v_sn, const float* v_bl,
                         const float* wwl, const float* wbl, const float* rwl,
                         GcParams p, float h, float* out_sn, float* out_bl,
                         void* stream) {
  if (R < 1 || C < 1) return ERR_SHAPE;
  if (bx < 1 || ty < 1 || bx * ty > MAX_THREADS || cs < 1 ||
      cs > MAX_CLUSTER)
    return ERR_GEOMETRY;
  const int col_blocks = (C + bx - 1) / bx;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(col_blocks * cs);
  cfg.blockDim = dim3(bx, ty);
  cfg.dynamicSmemBytes =
      (2 * static_cast<size_t>(ty) + 1) * bx * sizeof(float);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gc_array_step_kernel, v_sn, v_bl, wwl, wbl, rwl, p, h, out_sn,
      out_bl, R, C);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* gc_array_step_error(int code) {
  switch (code) {
    case ERR_SHAPE: return "array must have R >= 1 rows and C >= 1 columns";
    case ERR_GEOMETRY:
      return "geometry outside 1 <= bx * ty <= 1024, 1 <= cs <= 8";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
