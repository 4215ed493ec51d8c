// K6: the Householder column loop of one m x w panel -- V (m x w), T (w x w)
// and R (m x w) with Q = I - V T V^T -- as one kernel launch.
//
// Replaces mixedprecisionblockqr_tpu/ops/pallas/panel.py::panel_factor_fused
// (pl.pallas_call of _panel_kernel).  Semantics as there: unit-norm
// reflectors with beta = 2, sign +1 when alpha >= 0, beta = 0 for a column
// whose live norm sigma <= 1e-30, T[:j, j] = -beta T (V^T w), T[j, j] =
// beta, all arithmetic true fp32.
//
// The TPU kernel keeps the whole panel, V and T in VMEM for the column
// loop.  A 4096 x 128 panel is 2 MB, far beyond one SM's 227 KB, so here a
// thread-block cluster of up to 16 CTAs (a non-portable size) splits the
// panel's rows: each CTA holds its rows in its own shared memory -- up to
// 428 rows at w = 128, so 16 CTAs keep 6848 rows -- or, when they do not
// fit, works on them in place in R, which stays in L2.  The layout rule is
// ops/kernels/panel.py::panel_layout (128 rows per CTA aimed at, which
// utils/panel_probe.py measured fastest); the entry below only checks that
// a layout is one the kernel can run.  Thread (k, g) owns column k of the
// rows g, g + 4, ... of its CTA.  Per column j:
//   * after the first cluster barrier every warp adds the pushed (tail^2,
//     alpha) partials of column j in a butterfly, so every thread of every
//     CTA holds the same scalars (sigma, u, beta); one pass over the rows
//     writes w = x / |u| and turns column j - 1 below its diagonal into V;
//   * one pass gives the CTA's dots w^T work[:, k] for all k, in four
//     independent partial sums per thread (fixed order: runs repeat bit for
//     bit); the CTA pushes them into every CTA's shared memory, then the
//     second cluster barrier;
//   * every thread sums the pushed dots of its column itself and applies
//     the rank-1 update to its rows, column j included, four rows at a time
//     and with no branch per row; the squares of column j + 1 ride along,
//     and its four threads push them for the next step.
// V is kept strictly below the diagonal of the working rows (as LAPACK
// does; its diagonal goes to `vdiag`), so for column j, w^T work[:, k] is
// (V^T w)_k for k < j and (w^T P)_k for k >= j.  Nothing in the loop reads
// T: rank 0 only stores the dots (V^T w)_k, k < j -- column j of
// G = triu(V^T V, 1) -- in the global scratch G.  After the loop every CTA
// copies G into its shared memory and one warp per row of T runs that
// row's own forward recurrence T[i, j] = -beta_j sum_{i <= k < j} T[i, k]
// G[k, j], T[i, i] = beta_i, with the rows spread over the whole cluster.
// The output R is the upper triangle (exact zeros below the diagonal, where
// the TPU kernel leaves rounding residue); a NaN in the input reaches R
// through the dots, as on the TPU.
//
// What bounds it: the column loop is sequential (w steps, each two cluster
// barriers, two CTA barriers and two passes over the live rows), so it is
// latency-bound, far from its 4 m w^2 fp32 operations or its bytes: at
// 2048 x 128 on 16 CTAs a column takes about 5 us, more than half of it in
// the two cluster barriers.  utils/panel_probe.py --phases reads the
// phases' times from the kernel's own clock.
//
// A batch of B panels of one shape (the TSQR / CAQR leaves and tree levels,
// which the TPU reference factors under jax.vmap) is one launch,
// mpbqr_panel_factor_batched: a grid of (cluster, B) CTAs in clusters of
// (cluster, 1, 1), blockIdx.y picking the member, whose P, V, T, G and R
// lie B-strided in contiguous (B, m, w) / (B, w, w) arrays.  Each cluster
// still runs one panel as above, so a member's result is bit for bit that
// of a single launch at the same layout.  The batch's layout (fewer CTAs a
// member where that runs the B clusters in fewer waves) is ops/kernels/
// panel.py::batched_layout, which reads mpbqr_panel_factor_resident: how
// many clusters of a layout the card keeps resident at once (a cluster
// lies inside one GPC, so an H100 keeps 7 of 16 CTAs, not 132 / 16).
//
// Wider panels (w > 128; the TPU kernel holds any width in VMEM) take the
// wide route, mpbqr_panel_factor_wide: one C entry that issues the blocked
// schedule on the caller's stream, for one panel or a batch of B
// (mpbqr_panel_factor_wide_batched; the single entry is its B = 1).  For
// each sub-panel [c, e) of `sub` (128) columns, the last one narrower when
// w is not a multiple:
//   a. every member's sub-panel R[c:, c:e] (R is the working copy of P,
//      row stride w) is staged into a contiguous (B, m - c, b) scratch by
//      one cudaMemcpy3DAsync and factored by ONE K6 launch over the batch
//      (its layout in the plan), and V, R and T's diagonal blocks are
//      copied back, one 3-D copy each: Vk ((m - c) x b), Tk (b x b);
//   b. the trailing columns take the sub-panel's block reflector,
//      C = R[c:, e:] -= Vk (Tk^T (Vk^T C));
//   c. T's block column is merged, T[:c, c:e] = -T[:c, :c] (V[c:, :c]^T
//      Vk) Tk, into the zeroed T (gemm_nt's C -= A B on zeros).
// Steps b and c are 3 product launches each, whatever B is: each launch
// holds the B members (panel.cuh's Members, the member folded into the
// grid's x, every operand at its member stride), and each member's sums
// are those of a launch for it alone with the same split and tiles.
// The products are panel.cuh's gemm_tn (split-K over a cluster, fixed
// order) and gemm_nt, both true fp32 FMA: the rank-1 updates of the TPU
// kernel's body, blocked.  No library product and no TF32.  The layouts
// (K6's per sub-panel, the products' splits and tiles, chosen from the B
// members' tiles together) come from ops/kernels/panel.py::wide_layout /
// wide_batched_layout.  The staging costs three copies of an (m - c) x b
// block a sub-panel and member, which utils/panel_probe.py times beside
// the whole route.  The semantics stay
// K6's: beta = 0 columns leave zero rows and columns in T (Tk's are zero,
// so the merged block column is too), R is exact zeros below its diagonal
// (each sub-panel's K6 writes them), and a NaN reaches R through the
// updates and the later sub-panels.  What bounds it: the sub-panels' column
// loops (w / 128 K6 launches, each latency-bound as above); the products
// add 2 m w^2 operations at most, spread over the card.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "panel.cuh"

namespace mpbqr {

constexpr int kPfThreads = 512;
constexpr int kPfWarps = kPfThreads / 32;
constexpr int kPfCols = 128;                      // widest one-launch panel
constexpr int kPfGroups = kPfThreads / kPfCols;   // row groups per column
constexpr int kPfMaxCluster = 16;                 // non-portable cluster
constexpr long long kPfSmemLimit = 232448;        // bytes a block may use
// Floats of shared memory before the reflector entries and the rows: the
// pushed dots [16][128] and norm partials [16][4][2], the row groups' dots
// [4][128], beta [128], V's diagonal [128] and a pad of 4.
// ops/kernels/panel.py::_FIXED_FLOATS mirrors it.
constexpr int kPfFixedFloats = kPfMaxCluster * kPfCols +
                               2 * kPfMaxCluster * kPfGroups +
                               kPfGroups * kPfCols + 2 * kPfCols + 4;

// Dynamic shared memory of a layout: the fixed carve-out, the reflector
// entries of `rows` rows (padded to 4), and a region that holds the rows
// (in_smem) and, after the loop, G (w x w).
static inline long long pf_smem_bytes(int w, int rows, int in_smem) {
  const long long region = (long long)w * w;
  const long long held = in_smem ? (long long)rows * w : 0;
  return 4 * (kPfFixedFloats + ((rows + 3) & ~3) +
              (held > region ? held : region));
}

// Per-CTA clock64 sums of a launch's phases, as the CTA's last thread
// (column 127 of the last row group, live on every column) sees them,
// compiled in only with -DMPBQR_PANEL_PROF; read by utils/panel_probe.py
// --phases, which names the slots.
#ifdef MPBQR_PANEL_PROF
__device__ long long g_pf_prof[kPfMaxCluster][8];
#define PROF_INIT long long pt = clock64(), pacc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#define PROF(s) if (t == kPfThreads - 1) { const long long c = clock64(); pacc[s] += c - pt; pt = c; }
#define PROF_SAVE if (t == kPfThreads - 1) for (int s = 0; s < 8; ++s) g_pf_prof[rank][s] = pacc[s];
#else
#define PROF_INIT
#define PROF(s)
#define PROF_SAVE
#endif

template <bool kInSmem>
__global__ void __launch_bounds__(kPfThreads, 1)
panel_factor_kernel(const float* __restrict__ P, float* V, float* Tout,
                    float* G, float* R, int m, int w, int rows) {
  // Named apart from ns_chain.cuh's `smem` (a char array), which panel.cuh
  // brings into this file: dynamic shared arrays share one symbol.
  extern __shared__ __align__(16) float pf_smem[];
  // The batch member of this cluster (0 for a single panel).
  const long long member = blockIdx.y;
  P += member * m * w;
  V += member * m * w;
  R += member * m * w;
  Tout += member * w * w;
  G += member * w * w;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();

  float* rdots = pf_smem;                           // [16][128] pushed dots
  float* rnorm = rdots + kPfMaxCluster * kPfCols;   // [16][4] (tail^2, alpha)
  float* grp = rnorm + 2 * kPfMaxCluster * kPfGroups;  // [4][128] group dots
  float* betas = grp + kPfGroups * kPfCols;         // beta of each column
  float* vdiag = betas + kPfCols;                   // V's diagonal
  float* wv = vdiag + kPfCols + 4;                  // reflector, own rows
  float* region = wv + ((rows + 3) & ~3);           // rows, then G
  const int r0 = rank * rows;
  const int nr = max(0, min(rows, m - r0));
  // The route is a template argument, so that on the shared-memory route
  // the compiler knows every access to the rows is a shared one.
  float* work = kInSmem ? region : R + (long long)r0 * w;

  const int t = threadIdx.x;
  const int k = t % kPfCols, g = t / kPfCols;
  PROF_INIT

  for (long long e = t; e < (long long)nr * w; e += kPfThreads)
    work[e] = P[(long long)r0 * w + e];
  cluster.sync();  // every CTA runs before any shared memory is pushed

  // A row group's (tail^2, alpha) of a column, pushed by its one thread
  // into slot (rank, g) of every CTA, while the other threads still work.
  auto push_norm = [&](float tail, float alpha) {
    for (int q = 0; q < csize; ++q)
      reinterpret_cast<float2*>(cluster.map_shared_rank(rnorm, q))
          [rank * kPfGroups + g] = make_float2(tail, alpha);
  };

  // Column 0's norm partial, by the kPfGroups threads of column 0.
  if (k == 0) {
    float ta = 0.f, tb = 0.f, alpha = 0.f;
    int li = g;
    for (; li + kPfGroups < nr; li += 2 * kPfGroups) {
      const float v0 = work[(long long)li * w];
      const float v1 = work[(long long)(li + kPfGroups) * w];
      if (r0 + li > 0) ta = fmaf(v0, v0, ta); else alpha = v0;
      tb = fmaf(v1, v1, tb);  // row r0 + li + 4 > 0
    }
    if (li < nr) {
      const float v0 = work[(long long)li * w];
      if (r0 + li > 0) ta = fmaf(v0, v0, ta); else alpha = v0;
    }
    push_norm(ta + tb, alpha);
  }

  for (int j = 0; j < w; ++j) {
    const int lstart = max(0, j - r0);
    cluster.sync();  // every CTA's (tail^2, alpha) of column j is pushed
    PROF(0)
    // The column's scalars: every warp adds the csize x 4 pushed pairs in
    // a butterfly, which leaves the same sums in every lane, warp and CTA.
    const int lane = t & 31;
    const float2* rn = reinterpret_cast<const float2*>(rnorm);
    const int np = csize * kPfGroups;
    float tail2 = lane < np ? rn[lane].x : 0.f;
    float alpha = lane < np ? rn[lane].y : 0.f;
    if (lane + 32 < np) {
      tail2 += rn[lane + 32].x;
      alpha += rn[lane + 32].y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      tail2 += __shfl_xor_sync(0xffffffffu, tail2, o);
      alpha += __shfl_xor_sync(0xffffffffu, alpha, o);
    }
    const float sigma = sqrtf(fmaf(alpha, alpha, tail2));
    const float sgn = alpha >= 0.f ? 1.f : -1.f;
    const float u = alpha + sgn * sigma;
    const float unorm = sqrtf(fmaf(u, u, tail2));
    const bool live = sigma > 1e-30f;
    const float beta = live ? 2.f : 0.f;
    if (t == 0) {
      betas[j] = beta;
      vdiag[j] = live ? u / unorm : 0.f;
    }
    // Column j's reflector; column j - 1 below its diagonal becomes V here
    // (the update left its rows as it left every other column's).
    for (int li = lstart + t; li < nr; li += kPfThreads) {
      const int i = r0 + li;
      float* p = work + (long long)li * w + j;
      const float x = i == j ? u : *p;
      if (j > 0) p[-1] = wv[li];
      wv[li] = live ? x / unorm : 0.f;
    }
    __syncthreads();
    PROF(1)

    // d_k = sum over own rows i >= j of w_i work[i, k], every k < w, in
    // four independent partial sums of the group's rows.
    if (k < w) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int li = lstart + g;
      for (; li + 3 * kPfGroups < nr; li += 4 * kPfGroups) {
        const float* p = work + (long long)li * w + k;
        a0 = fmaf(wv[li], p[0], a0);
        a1 = fmaf(wv[li + kPfGroups], p[kPfGroups * w], a1);
        a2 = fmaf(wv[li + 2 * kPfGroups], p[2 * kPfGroups * w], a2);
        a3 = fmaf(wv[li + 3 * kPfGroups], p[3 * kPfGroups * w], a3);
      }
      for (; li < nr; li += kPfGroups)
        a0 = fmaf(wv[li], work[(long long)li * w + k], a0);
      grp[g * kPfCols + k] = (a0 + a1) + (a2 + a3);
    }
    __syncthreads();
    PROF(2)
    // The CTA's dots, pushed into slot `rank` of every CTA.
    for (int e = t; e < csize * kPfCols; e += kPfThreads) {
      const int q = e / kPfCols, kk = e % kPfCols;
      if (kk < w) {
        const float s = (grp[kk] + grp[kPfCols + kk]) +
                        (grp[2 * kPfCols + kk] + grp[3 * kPfCols + kk]);
        cluster.map_shared_rank(rdots, q)[rank * kPfCols + kk] = s;
      }
    }
    cluster.sync();  // every CTA's partial dots are pushed
    PROF(3)

    if (k < w && k < j && rank == 0 && g == 0) {
      // (V^T w)_k: column j of G, stored by rank 0 for the T build.
      float dk = 0.f;
      for (int q = 0; q < csize; ++q) dk += rdots[q * kPfCols + k];
      G[(long long)k * w + j] = dk;
    } else if (k < w && k >= j) {
      // The full dot of column k, by every thread of it in the same order.
      float dk = 0.f;
      for (int q = 0; q < csize; ++q) dk += rdots[q * kPfCols + k];
      // Rank-1 update of column k over the live rows, column j included
      // (its rows below the diagonal become V in the next step's pass).
      // Column j + 1's norm partial rides along: every lane adds the squares
      // of rows i >= j + 2 in two sums (cheaper than a select), and only the
      // thread of column j + 1 pushes them; the at most one row i <= j + 1
      // of the group comes first and gives alpha.  Four rows at a time,
      // their loads issued before the stores.
      const bool ncol = k == j + 1;
      float ta = 0.f, tb = 0.f, al = 0.f;
      constexpr int kS = kPfGroups;
      int li = lstart + g;
      for (; li < nr && r0 + li <= j + 1; li += kS) {
        float* p = work + (long long)li * w + k;
        const float v = *p - beta * (wv[li] * dk);
        *p = v;
        if (r0 + li == j + 1) al = v;
      }
      for (; li + 3 * kS < nr; li += 4 * kS) {
        float* p = work + (long long)li * w + k;
        const float x0 = p[0], x1 = p[kS * w], x2 = p[2 * kS * w],
                    x3 = p[3 * kS * w];
        const float w0 = wv[li], w1 = wv[li + kS], w2 = wv[li + 2 * kS],
                    w3 = wv[li + 3 * kS];
        const float v0 = x0 - beta * (w0 * dk), v1 = x1 - beta * (w1 * dk),
                    v2 = x2 - beta * (w2 * dk), v3 = x3 - beta * (w3 * dk);
        p[0] = v0;
        p[kS * w] = v1;
        p[2 * kS * w] = v2;
        p[3 * kS * w] = v3;
        ta = fmaf(v0, v0, ta);
        tb = fmaf(v1, v1, tb);
        ta = fmaf(v2, v2, ta);
        tb = fmaf(v3, v3, tb);
      }
      for (; li < nr; li += kS) {
        float* p = work + (long long)li * w + k;
        const float v = *p - beta * (wv[li] * dk);
        *p = v;
        ta = fmaf(v, v, ta);
      }
      if (ncol) push_norm(ta + tb, al);
    }
    PROF(4)
  }

  for (long long e = t; e < (long long)nr * w; e += kPfThreads) {
    const int li = (int)(e / w), c = (int)(e % w);
    const int i = r0 + li;
    const float v = work[e];
    const long long o = (long long)i * w + c;
    R[o] = c >= i ? v : 0.f;
    // Column w - 1 below its diagonal is still its reflector in wv.
    V[o] = c < i ? (c == w - 1 ? wv[li] : v) : (c == i ? vdiag[c] : 0.f);
  }
  __threadfence();
  cluster.sync();  // G is complete; no CTA reads the rows any more
  PROF(5)

  // T, one warp per row i, rows spread over the cluster.  Lane l keeps the
  // running sums acc_c = sum_{i <= k' < k} T[i, k'] G[k', j'] of columns
  // j' = l + 32 c; at step k the owner of column k turns its sum into
  // T[i, k] and broadcasts it.
  for (int e = t; e < w * w; e += kPfThreads) region[e] = __ldcg(G + e);
  __syncthreads();
  const int lane = t & 31, warp = t >> 5;
  for (int i = rank * kPfWarps + warp; i < w; i += csize * kPfWarps) {
    float acc[kPfCols / 32] = {0.f, 0.f, 0.f, 0.f};
    for (int kk = i; kk + 1 < w; ++kk) {
      float a = acc[0];
#pragma unroll
      for (int c = 1; c < kPfCols / 32; ++c)
        if ((kk >> 5) == c) a = acc[c];
      const float mine = kk == i ? betas[i] : -betas[kk] * a;
      const float tk = __shfl_sync(0xffffffffu, mine, kk & 31);
      const float* grow = region + (long long)kk * w;
#pragma unroll
      for (int c = 0; c < kPfCols / 32; ++c) {
        const int jp = lane + 32 * c;
        if (jp > kk && jp < w) acc[c] = fmaf(tk, grow[jp], acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kPfCols / 32; ++c) {
      const int jp = lane + 32 * c;
      if (jp < w)
        Tout[(long long)i * w + jp] =
            jp < i ? 0.f : (jp == i ? betas[i] : -betas[jp] * acc[c]);
    }
  }
  PROF(6)
  PROF_SAVE
}

// Whether the layout is one the kernel runs: 1 <= w <= 128, m >= w, a
// cluster of 1..16 CTAs whose `rows` each cover m, and `smem_bytes` equal
// to pf_smem_bytes of the route and within the block limit.
static bool pf_layout_ok(int m, int w, int cluster, int rows, int in_smem,
                         int smem_bytes) {
  if (w < 1 || w > kPfCols || m < w) return false;
  if (cluster < 1 || cluster > kPfMaxCluster || rows < 1) return false;
  if ((long long)cluster * rows < m) return false;
  const long long bytes = pf_smem_bytes(w, rows, in_smem);
  return bytes == smem_bytes && bytes <= kPfSmemLimit;
}

// The launch configuration of `batch` clusters of `cluster` CTAs, after
// the kernel's attributes (non-portable cluster size, `smem_bytes` of
// dynamic shared memory) are set.
template <bool kInSmem>
static cudaError_t pf_config(cudaLaunchConfig_t* cfg,
                             cudaLaunchAttribute* attr, int cluster,
                             int smem_bytes, void* stream, int batch = 1) {
  auto kern = panel_factor_kernel<kInSmem>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  *cfg = {};
  cfg->gridDim = dim3(cluster, batch, 1);
  cfg->blockDim = dim3(kPfThreads, 1, 1);
  cfg->dynamicSmemBytes = (size_t)smem_bytes;
  cfg->stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// Most members of one batched launch (the grid's y dimension).
constexpr int kPfMaxBatch = 65535;

// One K6 launch of a checked layout over `batch` B-strided panels on
// `stream`; the error of the check (cudaErrorInvalidValue), the
// configuration or the launch.
static cudaError_t pf_launch(const float* P, float* V, float* T, float* G,
                             float* R, int m, int w, int cluster, int rows,
                             int in_smem, int smem_bytes, void* stream,
                             int batch = 1) {
  if (!pf_layout_ok(m, w, cluster, rows, in_smem, smem_bytes) || batch < 1 ||
      batch > kPfMaxBatch)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err =
      in_smem
          ? pf_config<true>(&cfg, attr, cluster, smem_bytes, stream, batch)
          : pf_config<false>(&cfg, attr, cluster, smem_bytes, stream, batch);
  if (err != cudaSuccess) return err;
  err = in_smem ? cudaLaunchKernelEx(&cfg, panel_factor_kernel<true>, P, V, T,
                                     G, R, m, w, rows)
                : cudaLaunchKernelEx(&cfg, panel_factor_kernel<false>, P, V,
                                     T, G, R, m, w, rows);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Integers of one sub-panel in the wide route's plan (ops/kernels/panel.py::
// WideStep.args): K6's layout (cluster, rows, in_smem, smem_bytes); the
// trailing update's Y = Vk^T C and Z = Tk^T Y (split, chunk each) and
// C -= Vk Z (bm, bn); the T merge's X = V^T Vk (split, chunk), Y2 = T X and
// T[:c, c:e] -= Y2 Tk (bm, bn each).
constexpr int kPfWideStep = 16;

static inline long long pf_pad4(long long n) { return (n + 3) & ~3LL; }

// Floats of the wide route's scratch for B members: the staged sub-panels,
// their V and R (B x m x sub each), their T and K6's G (B x sub x sub
// each), Y and Z (B x sub x w each), X and Y2 (B x w x sub each), every
// piece padded to 4 floats.
static inline long long pf_wide_scratch_floats(int B, int m, int w,
                                               int sub) {
  return 3 * pf_pad4((long long)B * m * sub) +
         2 * pf_pad4((long long)B * sub * sub) +
         4 * pf_pad4((long long)B * sub * w);
}

// cudaMemcpy3DAsync of `depth` blocks of `height` rows of `width` floats
// between device arrays of row pitch `*pitch` floats and `*rows` rows a
// block (so the blocks lie pitch * rows floats apart).
static cudaError_t pf_copy3d(float* dst, int dpitch, int drows,
                             const float* src, int spitch, int srows,
                             int width, int height, int depth,
                             cudaStream_t st) {
  const size_t f = sizeof(float);
  cudaMemcpy3DParms p = {};
  p.srcPtr = make_cudaPitchedPtr(const_cast<float*>(src), f * spitch,
                                 f * spitch, srows);
  p.dstPtr = make_cudaPitchedPtr(dst, f * dpitch, f * dpitch, drows);
  p.extent = make_cudaExtent(f * width, height, depth);
  p.kind = cudaMemcpyDeviceToDevice;
  return cudaMemcpy3DAsync(&p, st);
}

}  // namespace mpbqr

#define MPBQR_PF_TRY(x)                     \
  do {                                      \
    const cudaError_t e_ = (x);             \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)

extern "C" {

#ifdef MPBQR_PANEL_PROF
// Copy the phase clocks (16 x 8 signed 64-bit) to the host.
int mpbqr_panel_prof(long long* prof) {
  return (int)cudaMemcpyFromSymbol(prof, mpbqr::g_pf_prof,
                                   sizeof(mpbqr::g_pf_prof));
}
#endif

// The largest cluster (CTAs, at most 16) of which the card can place at
// least one with `smem_bytes` of dynamic shared memory per CTA, in *out
// (0 when not even one CTA fits).  Returns the CUDA error of the query.
int mpbqr_panel_factor_max_cluster(int smem_bytes, int* out) {
  using namespace mpbqr;
  *out = 0;
  for (int c = kPfMaxCluster; c >= 1; --c) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t err = pf_config<true>(&cfg, attr, c, smem_bytes, nullptr);
    if (err != cudaSuccess) return (int)err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, panel_factor_kernel<true>,
                                         &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters >= 1) {
      *out = c;
      return 0;
    }
  }
  return 0;
}

// How many clusters of `cluster` CTAs with `smem_bytes` of dynamic shared
// memory (in shared memory when `in_smem`) the card keeps resident at once,
// in *out (cudaOccupancyMaxActiveClusters): a batch of B such clusters runs
// in ceil(B / *out) waves.  Returns the CUDA error of the query.
int mpbqr_panel_factor_resident(int cluster, int in_smem, int smem_bytes,
                                int* out) {
  using namespace mpbqr;
  *out = 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err =
      in_smem ? pf_config<true>(&cfg, attr, cluster, smem_bytes, nullptr)
              : pf_config<false>(&cfg, attr, cluster, smem_bytes, nullptr);
  if (err != cudaSuccess) return (int)err;
  return in_smem ? (int)cudaOccupancyMaxActiveClusters(
                       out, panel_factor_kernel<true>, &cfg)
                 : (int)cudaOccupancyMaxActiveClusters(
                       out, panel_factor_kernel<false>, &cfg);
}

// P (m x w, fp32, row-major, read only) -> V (m x w), T (w x w) and R
// (m x w, upper triangle); G (w x w) is scratch.  All device pointers; one
// cluster launch on `stream` with the layout that ops/kernels/panel.py::
// panel_layout gives: `cluster` CTAs of `rows` rows each (the last may
// hold fewer), in shared memory when `in_smem`, else in place in R, with
// `smem_bytes` of dynamic shared memory.  Returns cudaErrorInvalidValue
// for a shape or layout the kernel does not run, else the launch's error.
int mpbqr_panel_factor(const float* P, float* V, float* T, float* G,
                       float* R, int m, int w, int cluster, int rows,
                       int in_smem, int smem_bytes, void* stream) {
  return (int)mpbqr::pf_launch(P, V, T, G, R, m, w, cluster, rows, in_smem,
                               smem_bytes, stream);
}

// The batched K6: B panels of one shape in ONE launch.  P, V, R (B x m x w)
// and T, G (B x w x w) contiguous, member b at offset b m w (b w w); the
// layout, one for every member (ops/kernels/panel.py::batched_layout), as
// mpbqr_panel_factor takes it.  Member b's outputs are bit for bit those of
// mpbqr_panel_factor on its panel at the same layout.  Returns
// cudaErrorInvalidValue for a shape, layout or B (1..65535) the kernel
// does not run, else the launch's error.
int mpbqr_panel_factor_batched(const float* P, float* V, float* T, float* G,
                               float* R, int B, int m, int w, int cluster,
                               int rows, int in_smem, int smem_bytes,
                               void* stream) {
  return (int)mpbqr::pf_launch(P, V, T, G, R, m, w, cluster, rows, in_smem,
                               smem_bytes, stream, B);
}

// Floats of scratch mpbqr_panel_factor_wide_batched takes for B m x w
// panels in sub-panels of `sub` columns.
long long mpbqr_panel_factor_wide_batched_scratch_floats(int B, int m, int w,
                                                         int sub) {
  return mpbqr::pf_wide_scratch_floats(B, m, w, sub);
}

// Floats of scratch mpbqr_panel_factor_wide takes for an m x w panel in
// sub-panels of `sub` columns.
long long mpbqr_panel_factor_wide_scratch_floats(int m, int w, int sub) {
  return mpbqr::pf_wide_scratch_floats(1, m, w, sub);
}

int mpbqr_panel_factor_wide_batched(const float* P, float* V, float* T,
                                    float* R, float* scratch, int B, int m,
                                    int w, int sub, const int* plan,
                                    int nsteps, void* stream);

// The wide route (see the top of this file): P (m x w, fp32, row-major,
// read only) -> V (m x w), T (w x w) and R (m x w, upper triangle), as
// mpbqr_panel_factor gives them, for any 1 <= w <= m.  `scratch` holds
// mpbqr_panel_factor_wide_scratch_floats(m, w, sub) floats; `plan` (host
// memory) holds kPfWideStep integers for each of the nsteps = ceil(w / sub)
// sub-panels (ops/kernels/panel.py::wide_layout).  The package passes
// sub = WIDE_SUB (128); only utils/panel_probe.py passes another width, to
// time it.  Everything is issued on
// `stream`.  Returns cudaErrorInvalidValue for a shape or a plan the
// kernels do not run, else the first error of a copy or launch.
int mpbqr_panel_factor_wide(const float* P, float* V, float* T, float* R,
                            float* scratch, int m, int w, int sub,
                            const int* plan, int nsteps, void* stream) {
  return mpbqr_panel_factor_wide_batched(P, V, T, R, scratch, 1, m, w, sub,
                                         plan, nsteps, stream);
}

// The wide route over a batch: B m x w panels, P, V, R (B x m x w) and T
// (B x w x w) contiguous, as mpbqr_panel_factor_wide gives each of them.
// `scratch` holds mpbqr_panel_factor_wide_batched_scratch_floats(B, m, w,
// sub) floats; `plan` is one member's (ops/kernels/panel.py::
// wide_batched_layout: each step's K6 layout and product layouts for the
// batch).  Each step stages, factors (one K6 launch over the B sub-panels)
// and copies back by one 3-D copy each, then issues each product once for
// the B members.  Member b's outputs are bit for bit those of
// mpbqr_panel_factor_wide on its panel with the same plan.  Returns
// cudaErrorInvalidValue for a shape, B or plan the kernels do not run,
// else the first error of a copy or launch.
int mpbqr_panel_factor_wide_batched(const float* P, float* V, float* T,
                                    float* R, float* scratch, int B, int m,
                                    int w, int sub, const int* plan,
                                    int nsteps, void* stream) {
  using namespace mpbqr;
  if (w < 1 || m < w || sub < 1 || sub > kPfCols || B < 1 ||
      B > kPfMaxBatch || nsteps != (w + sub - 1) / sub)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t f = sizeof(float);
  const long long mw = (long long)m * w, ww = (long long)w * w;
  const long long big = pf_pad4((long long)B * m * sub);
  const long long tri = pf_pad4((long long)B * sub * sub);
  const long long row = pf_pad4((long long)B * sub * w);
  float* Ps = scratch;
  float* Vk = Ps + big;
  float* Rk = Vk + big;
  float* Tk = Rk + big;
  float* G = Tk + tri;
  float* Y = G + tri;
  float* Z = Y + row;
  float* X = Z + row;
  float* Y2 = X + row;
  const auto d2d = cudaMemcpyDeviceToDevice;
  MPBQR_PF_TRY(cudaMemcpyAsync(R, P, f * B * mw, d2d, st));
  MPBQR_PF_TRY(cudaMemsetAsync(V, 0, f * B * mw, st));
  MPBQR_PF_TRY(cudaMemsetAsync(T, 0, f * B * ww, st));
  for (int s = 0; s < nsteps; ++s) {
    const int* p = plan + kPfWideStep * s;
    const int c = s * sub, e = c + sub < w ? c + sub : w;
    const int b = e - c, mk = m - c, n2 = w - e;
    const long long kb = (long long)mk * b, bb = (long long)b * b;
    float* Rc = R + (size_t)c * w + c;  // member 0's sub-panel, top left
    // a. K6 on the staged sub-panels; V, R and Tk back into place.
    MPBQR_PF_TRY(pf_copy3d(Ps, b, mk, Rc, w, m, b, mk, B, st));
    MPBQR_PF_TRY(pf_launch(Ps, Vk, Tk, G, Rk, mk, b, p[0], p[1], p[2], p[3],
                           stream, B));
    MPBQR_PF_TRY(pf_copy3d(Rc, w, m, Rk, b, mk, b, mk, B, st));
    MPBQR_PF_TRY(pf_copy3d(V + (size_t)c * w + c, w, m, Vk, b, mk, b, mk, B,
                           st));
    MPBQR_PF_TRY(pf_copy3d(T + (size_t)c * w + c, w, w, Tk, b, b, b, b, B,
                           st));
    // Member strides: Vk (m - c) x b, Tk b x b, R / V m x w, T w x w,
    // and Y, Z, X, Y2 sub x w each, as the scratch lays them out.
    const long long sw = (long long)sub * w;
    // b. C = R[c:, e:] -= Vk (Tk^T (Vk^T C)).
    if (n2 > 0) {
      float* C = Rc + b;
      MPBQR_PF_TRY(tn(st, false, b, n2, mk, Vk, b, C, w, Y, n2, p[4], p[5],
                      Members{B, kb, mw, sw}));
      MPBQR_PF_TRY(tn(st, false, b, n2, b, Tk, b, Y, n2, Z, n2, p[6], p[7],
                      Members{B, bb, sw, sw}));
      MPBQR_PF_TRY(nt(st, false, mk, n2, b, Vk, b, Z, n2, C, w, true, p[8],
                      p[9], Members{B, kb, sw, mw}));
    }
    // c. T[:c, c:e] = -T[:c, :c] (V[c:, :c]^T Vk) Tk (V's rows above c are
    // zero in columns c:e, so the sum runs over rows c..m).
    if (c > 0) {
      MPBQR_PF_TRY(tn(st, false, c, b, mk, V + (size_t)c * w, w, Vk, b, X, b,
                      p[10], p[11], Members{B, mw, kb, sw}));
      MPBQR_PF_TRY(nt(st, false, c, b, c, T, w, X, b, Y2, b, false, p[12],
                      p[13], Members{B, ww, sw, sw}));
      MPBQR_PF_TRY(nt(st, false, c, b, b, Y2, b, Tk, b, T + c, w, true,
                      p[14], p[15], Members{B, sw, bb, ww}));
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
