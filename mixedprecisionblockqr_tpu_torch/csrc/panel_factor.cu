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
// 405 rows at w = 128, so 16 CTAs keep 6480 rows -- or, when they do not
// fit, works on them in place in R, which stays in L2.  The layout rule is
// ops/kernels/panel.py::panel_layout (128 rows per CTA aimed at, which
// utils/panel_probe.py measured fastest); the entry below only checks that
// a layout is one the kernel can run.  Thread (k, g) owns column k of
// every fourth live row of its CTA.  With x the live part of column j
// (alpha = x_j) and A the working rows, the reflector is w = x / |u| with
// u = alpha + sign(alpha) sigma at row j, so for every column c
//   w^T A_c = (sum over rows i > j of x_i A_ic + u A_jc) / |u|,
// which needs only sums that are known before u: the partial dots of the
// rows below j and row j itself.  Per column j, ONE cluster barrier:
//   * the exchange: after the barrier every warp adds the pushed partial
//     sums of columns j and j + 1 in one tree over the CTAs, so every
//     thread of every CTA holds the same scalars (sigma = sqrt(alpha^2 +
//     sum x_i^2), u, beta) and the dots d_j, d_{j+1}; the first row group
//     adds each column's pushed partial dots and keeps beta d_k in shared
//     memory for the CTA;
//   * the x' sub-pass: one thread a row writes w_i as column j's V below
//     the diagonal (row j: R[j, j]) and x'_i, column j + 1 after the
//     update, into the rows and beside w_i in a per-row vector (one copy,
//     so the fused pass and the pushed dots see the same rounding), then a
//     CTA barrier;
//   * the fused pass: thread (k, g) applies the rank-1 update to column
//     k > j + 1 over its rows and in the same pass sums c_k = x'_i A'_ik
//     over its rows i > j + 1 (A' the updated column, V's column for
//     k <= j, x' for k = j + 1), in four independent partial sums (fixed
//     order: runs repeat bit for bit); row j + 1's entries are kept apart;
//     a CTA barrier;
//   * the push: each CTA adds its four row groups' sums and stores them,
//     16 bytes a store, into slot `rank` of every CTA's shared memory;
//     the CTA that holds row j + 1 pushes that row beside them, and one
//     thread a CTA the sums of columns j + 1 and j + 2 as a pair.  The
//     buffers have two copies by column parity: a CTA that is a column
//     ahead never overwrites what a slower one still reads.
// V is kept strictly below the diagonal of the working rows (as LAPACK
// does; its diagonal goes to `vdiag`), so the dots of a column k <= j are
// (V^T w_{j+1})_k.  Nothing in the loop reads T: rank 0 stores those dots
// -- column j of G = triu(V^T V, 1) -- in the global scratch G at column
// j's exchange.  After the loop every CTA
// copies G into its shared memory and one warp per row of T runs that
// row's own forward recurrence T[i, j] = -beta_j sum_{i <= k < j} T[i, k]
// G[k, j], T[i, i] = beta_i, with the rows spread over the whole cluster.
// The output R is the upper triangle (exact zeros below the diagonal, where
// the TPU kernel leaves rounding residue); a NaN in the input reaches R
// through the dots, as on the TPU.  A beta = 0 column has w = 0: its dots
// are 0 * (its sums), which keeps a NaN or inf of another column (as a
// sum of 0 * A_ic would), except that a column that is itself NaN passes
// its NaN to its own R[j, j] only.
//
// What bounds it: the column loop is sequential (w steps, each one cluster
// barrier, two CTA barriers and one pass over the live rows), so it is
// latency-bound, far from its 4 m w^2 fp32 operations or its bytes.
// utils/panel_probe.py --phases reads the phases' times from the kernel's
// own clock (PERF.md: at 2048 x 128 on 16 CTAs the loop this one replaced
// took 4.5 us a column, 2.2 of them in its two cluster barriers).
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
// Shared memory every launch reserves at least: more than half an SM's
// 228 KB, so two CTAs never share an SM (the batched layouts count the
// clusters the card keeps resident as clusters of whole SMs).
constexpr int kPfOneCtaSmem = 116 * 1024;
// Floats of shared memory before the per-row vectors and the rows: the
// pushed partial dots [2][16][128], pivot rows [2][128] and the partial
// sums of the next two columns [2][16][2] (two copies each, by column
// parity), the row groups' dots [4][128], the CTA's pivot row [128], the
// scaled dots of the update [128], beta [128] and V's diagonal [128].
// ops/kernels/panel.py::_FIXED_FLOATS mirrors it.
constexpr int kPfFixedFloats = 2 * kPfMaxCluster * kPfCols + 2 * kPfCols +
                               4 * kPfMaxCluster + kPfGroups * kPfCols +
                               4 * kPfCols;

// Dynamic shared memory of a layout: the fixed carve-out, two vectors of
// `rows` entries (the reflector and the next column, each padded to 4),
// and a region that holds the rows (in_smem) and, after the loop, G
// (w x w).
static inline long long pf_smem_bytes(int w, int rows, int in_smem) {
  const long long region = (long long)w * w;
  const long long held = in_smem ? (long long)rows * w : 0;
  return 4 * (kPfFixedFloats + 2 * ((rows + 3) & ~3) +
              (held > region ? held : region));
}

// Per-CTA clock64 sums of a launch's phases, as the CTA's last thread
// (column 127 of the last row group) sees them, compiled in only with
// -DMPBQR_PANEL_PROF; read by utils/panel_probe.py --phases, which names
// the slots: 0 the exchange (the one cluster barrier a column), 1 the
// scalars and dots, 2 the x' sub-pass, 3 the fused pass, 4 the push, 5 the
// outputs, 6 the T build.
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

  constexpr int kSlab = kPfMaxCluster * kPfCols;
  float* pdots = pf_smem;                        // [2][16][128] partial dots
  float* prow = pdots + 2 * kSlab;               // [2][128] pivot row
  float2* pn = reinterpret_cast<float2*>(prow + 2 * kPfCols);  // [2][16]
  float* grp = prow + 2 * kPfCols + 4 * kPfMaxCluster;  // [4][128] groups
  float* grow = grp + kPfGroups * kPfCols;       // the CTA's pivot row
  float* bdk = grow + kPfCols;                   // beta w^T A_k, k > j + 1
  float* betas = bdk + kPfCols;                  // beta of each column
  float* vdiag = betas + kPfCols;                // V's diagonal
  // (w_i, x'_i) of the own rows: column j's reflector and column j + 1
  // after the update.
  float2* wx = reinterpret_cast<float2*>(vdiag + kPfCols);
  float* region = vdiag + kPfCols + 2 * ((rows + 3) & ~3);  // rows, then G
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

  // j = -1 is the prologue: column 0's partial dots and row 0, no update.
  for (int j = -1; j < w; ++j) {
    const int lstart = max(0, j - r0);
    const bool next = j + 1 < w;  // a column j + 1 whose dots to take
    if (j >= 0) {
      cluster.sync();  // column j's partial dots and row j are pushed
      PROF(0)
      // Column j's and j + 1's sums of the pushed partials (tail^2 = the
      // sum over rows i > j of x_i^2), in every warp the same tree over
      // the CTAs: lanes 0-15 add column j's, lanes 16-31 column j + 1's.
      const float* pr = prow + (j & 1) * kPfCols;
      const int lane = t & 31, q = lane & 15;
      float v = q < csize ? (lane < 16 ? pn[(j & 1) * kPfMaxCluster + q].x
                                       : pn[(j & 1) * kPfMaxCluster + q].y)
                          : 0.f;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      const float tail2 = __shfl_sync(0xffffffffu, v, 0);
      const float sj1 = __shfl_sync(0xffffffffu, v, 16);
      const float alpha = pr[j];
      const float sigma = sqrtf(fmaf(alpha, alpha, tail2));
      const float sgn = alpha >= 0.f ? 1.f : -1.f;
      const float u = alpha + sgn * sigma;
      const float unorm = sqrtf(fmaf(u, u, tail2));
      const bool live = sigma > 1e-30f;
      const float beta = live ? 2.f : 0.f;
      const float rinv = 1.f / unorm;
      // w^T A_c = (sum over rows i > j of x_i A_ic + u A_jc) / |u|, from
      // the sum s of the partial dots: row j never entered them, so
      // nothing cancels.  A beta = 0 column keeps zero dots as 0 * s: a
      // NaN or inf in column c (or in column j itself) still reaches
      // them, as a sum of 0 * A_ic would; where column j is NaN only its
      // own dot is.
      const bool xnum = !isnan(sigma);
      auto dot = [&](int c, float s) {
        s = fmaf(u, pr[c], s);
        return live ? s * rinv : (xnum || c == j ? 0.f * s : 0.f);
      };
      if (g == 0 && k < w) {
        // The first row group sums column k's partials (in CTA order,
        // their loads issued before the adds) for the whole CTA.
        const float* pd = pdots + (j & 1) * kSlab + k;
        float vk[kPfMaxCluster];
#pragma unroll
        for (int c = 0; c < kPfMaxCluster; ++c)
          vk[c] = c < csize ? pd[c * kPfCols] : 0.f;
        float sk = 0.f;
#pragma unroll
        for (int c = 0; c < kPfMaxCluster; ++c) sk += vk[c];
        const float dk = dot(k, sk);
        bdk[k] = k > j + 1 ? beta * dk : 0.f;
        // (V^T w)_k, k < j: column j of G, stored by rank 0 for the T
        // build.
        if (rank == 0 && k < j) G[(long long)k * w + j] = dk;
      }
      const float bj = beta * dot(j, tail2);
      const float b1 = next ? beta * dot(j + 1, sj1) : 0.f;
      if (t == 0) {
        betas[j] = beta;
        vdiag[j] = live ? u * rinv : 0.f;
      }
      PROF(1)
      // The x' sub-pass, one thread a row i >= j: w_i = x_i / |u| (row j:
      // u / |u|) becomes column j's V below the diagonal (row j: R[j, j]),
      // and column j + 1 takes the update, x'_i, kept with w_i in wx (and
      // in the rows) before any thread reads it in the fused pass.
      for (int li = lstart + t; li < nr; li += kPfThreads) {
        const bool diag = r0 + li == j;
        const float wl = live ? (diag ? u : wx[li].y) * rinv : 0.f;
        float* p = work + (long long)li * w + j;
        p[0] = diag ? fmaf(-bj, wl, alpha) : wl;
        const float x = next ? fmaf(-b1, wl, p[1]) : 0.f;
        if (next) p[1] = x;
        wx[li] = make_float2(wl, x);
      }
    } else {
      for (int li = t; li < nr; li += kPfThreads)
        wx[li] = make_float2(0.f, work[(long long)li * w]);
    }
    __syncthreads();
    PROF(2)

    // The fused pass of thread (k, g) over the group's rows i >= j: the
    // rank-1 update of column k > j + 1 and, in the same pass, the
    // partial dot of the next column, c_k = sum over rows i > j + 1 of
    // x'_i A'_ik (A'_k the updated column, V's column for k <= j, x'
    // itself for k = j + 1), in four independent sums (fixed order: runs
    // repeat bit for bit), and row j + 1's entry A'_{j+1,k}, which the
    // dots leave out.
    float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f, rv = 0.f;
    if (k < w && next) {
      const bool upd = j >= 0 && k > j + 1;
      const float bd = upd ? bdk[k] : 0.f;
      constexpr int kS = kPfGroups;
      int li = lstart + g;
      // The at most one row i <= j + 1 of the group.
      for (; li < nr && r0 + li <= j + 1; li += kS) {
        float* p = work + (long long)li * w + k;
        float v = *p;
        if (upd) {
          v = fmaf(-bd, wx[li].x, v);
          *p = v;
        }
        rv = v;
      }
      // Eight rows at a time, then four, their loads issued before the
      // stores; the r-th of them adds into sum r % 4.
      for (; li + 7 * kS < nr; li += 8 * kS) {
        float* p = work + (long long)li * w + k;
        float a[8];
        float2 e[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          a[r] = p[r * kS * w];
          e[r] = wx[li + r * kS];
        }
        if (upd) {
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            a[r] = fmaf(-bd, e[r].x, a[r]);
            p[r * kS * w] = a[r];
          }
        }
        c0 = fmaf(e[0].y, a[0], c0);
        c1 = fmaf(e[1].y, a[1], c1);
        c2 = fmaf(e[2].y, a[2], c2);
        c3 = fmaf(e[3].y, a[3], c3);
        c0 = fmaf(e[4].y, a[4], c0);
        c1 = fmaf(e[5].y, a[5], c1);
        c2 = fmaf(e[6].y, a[6], c2);
        c3 = fmaf(e[7].y, a[7], c3);
      }
      for (; li + 3 * kS < nr; li += 4 * kS) {
        float* p = work + (long long)li * w + k;
        float a[4];
        float2 e[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a[r] = p[r * kS * w];
          e[r] = wx[li + r * kS];
        }
        if (upd) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            a[r] = fmaf(-bd, e[r].x, a[r]);
            p[r * kS * w] = a[r];
          }
        }
        c0 = fmaf(e[0].y, a[0], c0);
        c1 = fmaf(e[1].y, a[1], c1);
        c2 = fmaf(e[2].y, a[2], c2);
        c3 = fmaf(e[3].y, a[3], c3);
      }
      for (; li < nr; li += kS) {
        float* p = work + (long long)li * w + k;
        const float2 e = wx[li];
        float a = *p;
        if (upd) {
          a = fmaf(-bd, e.x, a);
          *p = a;
        }
        c0 = fmaf(e.y, a, c0);
      }
    }
    if (next) {
      grp[g * kPfCols + k] = (c0 + c1) + (c2 + c3);
      // Row j + 1, from the group that passed it if this CTA holds it
      // (a step's groups start at row lstart).
      const int l1 = j + 1 - r0;
      if (l1 >= 0 && l1 < nr && (l1 - lstart) % kPfGroups == g)
        grow[k] = rv;
    }
    __syncthreads();
    PROF(3)
    if (next) {
      // The CTA's partial dots (the four groups' sums added), into slot
      // `rank` of every CTA, and, from the CTA that holds it, row j + 1:
      // 16-byte stores of four columns, the first four warps the dots,
      // the next four the row; then one thread a CTA q the partial sums
      // of columns j + 1 and j + 2 (added as the dots are) into slot
      // `rank` of q's pairs.
      const int par = (j + 1) & 1;
      const int piece = t % 32, kk = 4 * piece, wq = (t / 32) % 4;
      const float4* g4 = reinterpret_cast<const float4*>(grp);
      if (t < 128 && kk < w) {
        const float4 a = g4[piece], b = g4[32 + piece], c = g4[64 + piece],
                     d = g4[96 + piece];
        const float4 sum = make_float4((a.x + b.x) + (c.x + d.x),
                                       (a.y + b.y) + (c.y + d.y),
                                       (a.z + b.z) + (c.z + d.z),
                                       (a.w + b.w) + (c.w + d.w));
        for (int qq = wq; qq < csize; qq += 4)
          *reinterpret_cast<float4*>(cluster.map_shared_rank(pdots, qq) +
                                     par * kSlab + rank * kPfCols + kk) =
              sum;
      } else if (t < 256 && kk < w && j + 1 >= r0 && j + 1 < r0 + nr) {
        const float4 row = reinterpret_cast<const float4*>(grow)[piece];
        for (int qq = wq; qq < csize; qq += 4)
          *reinterpret_cast<float4*>(cluster.map_shared_rank(prow, qq) +
                                     par * kPfCols + kk) = row;
      } else if (t >= 256 && t - 256 < csize) {
        auto col = [&](int c) {
          return c < w ? (grp[c] + grp[kPfCols + c]) +
                             (grp[2 * kPfCols + c] + grp[3 * kPfCols + c])
                       : 0.f;
        };
        cluster.map_shared_rank(pn, t - 256)[par * kPfMaxCluster + rank] =
            make_float2(col(j + 1), col(j + 2));
      }
    }
    PROF(4)
  }

  for (long long e = t; e < (long long)nr * w; e += kPfThreads) {
    const int li = (int)(e / w), c = (int)(e % w);
    const int i = r0 + li;
    const float v = work[e];
    const long long o = (long long)i * w + c;
    R[o] = c >= i ? v : 0.f;
    V[o] = c < i ? v : (c == i ? vdiag[c] : 0.f);
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
      const float* gk = region + (long long)kk * w;
#pragma unroll
      for (int c = 0; c < kPfCols / 32; ++c) {
        const int jp = lane + 32 * c;
        if (jp > kk && jp < w) acc[c] = fmaf(tk, gk[jp], acc[c]);
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
// dynamic shared memory, at least kPfOneCtaSmem) are set.
template <bool kInSmem>
static cudaError_t pf_config(cudaLaunchConfig_t* cfg,
                             cudaLaunchAttribute* attr, int cluster,
                             int smem_bytes, void* stream, int batch = 1) {
  auto kern = panel_factor_kernel<kInSmem>;
  const int reserve = smem_bytes > kPfOneCtaSmem ? smem_bytes : kPfOneCtaSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, reserve);
  if (err != cudaSuccess) return err;
  *cfg = {};
  cfg->gridDim = dim3(cluster, batch, 1);
  cfg->blockDim = dim3(kPfThreads, 1, 1);
  cfg->dynamicSmemBytes = (size_t)reserve;
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
