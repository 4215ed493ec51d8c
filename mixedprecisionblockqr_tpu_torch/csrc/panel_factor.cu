// K6: the Householder column loop of one m x w panel -- V (m x w), T (w x w)
// and R (m x w) with Q = I - V T V^T -- as one kernel launch.
//
// Replaces mixedprecisionblockqr_tpu/ops/pallas/panel.py::panel_factor_fused
// (pl.pallas_call of _panel_kernel).  Semantics as there: unit-norm
// reflectors with beta = 2, sign +1 when alpha >= 0, beta = 0 for a column
// whose live norm sigma <= 1e-30, T built column by column
// (T[:j, j] = -beta T (V^T w), T[j, j] = beta), all arithmetic true fp32.
//
// The TPU kernel keeps the whole panel, V and T in VMEM for the column
// loop.  A 2048 x 128 panel is 1 MB, far beyond one SM's 227 KB, so here a
// thread-block cluster of up to 8 CTAs splits the panel's rows: each CTA
// holds its rows in its own shared memory (or, when they do not fit, works
// on them in place in R, which stays in L2), and the per-column reductions
// -- the column norm and the dots w^T [V | P] -- are exchanged through
// distributed shared memory with two cluster barriers per column.
// Rank 0 also builds T in its shared memory.
//
// One pass over a CTA's rows gives both dot vectors of a column: V is kept
// strictly below the diagonal of the working rows (as LAPACK does; its
// diagonal goes to `vdiag`), so for column j, w^T work[:, k] is (V^T w)_k
// for k < j and (w^T P)_k for k >= j.  The output R is the upper triangle
// (exact zeros below the diagonal, where the TPU kernel leaves rounding
// residue); a NaN in the input reaches R through the dots, as on the TPU.
//
// What bounds it: the column loop is sequential (w steps, each two cluster
// barriers and two passes over the live rows), so it is latency-bound; at
// 2048 x 128 each CTA's 256 rows are 128 KB of shared memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace mpbqr {

constexpr int kPfThreads = 512;
constexpr int kPfCols = 128;                      // widest panel taken
constexpr int kPfGroups = kPfThreads / kPfCols;   // row groups per column
constexpr int kPfMaxCluster = 8;                  // portable cluster size
constexpr int kPfRowsTarget = 256;                // rows per CTA aimed at
constexpr long long kPfSmemLimit = 232448;        // bytes a block may use

// Floats of shared memory besides the working rows.
static inline long long pf_base_floats(int w, int rows) {
  return (long long)w * w + rows + kPfGroups * kPfCols + 2 * kPfCols +
         2 * kPfGroups + 2 + kPfCols + 4;
}

__global__ void __launch_bounds__(kPfThreads)
panel_factor_kernel(const float* __restrict__ P, float* V, float* Tout,
                    float* R, int m, int w, int rows, int in_smem) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();

  float* Tcm = smem;                       // T, column-major (rank 0)
  float* wv = Tcm + w * w;                 // reflector entries of own rows
  float* grp = wv + rows;                  // row-group partial dots
  float* dpart = grp + kPfGroups * kPfCols;  // this CTA's dots (cluster)
  float* dfull = dpart + kPfCols;          // reduced dots
  float* npart = dfull + kPfCols;          // row-group (tail2, alpha)
  float* nrm = npart + 2 * kPfGroups;      // this CTA's (tail2, alpha)
  float* vdiag = nrm + 2;                  // V's diagonal
  float* scal = vdiag + kPfCols;           // unorm, u, live, beta
  const int r0 = rank * rows;
  const int nr = max(0, min(rows, m - r0));
  float* work = in_smem ? scal + 4 : R + (long long)r0 * w;

  const int t = threadIdx.x;
  const int k = t % kPfCols, g = t / kPfCols;

  for (long long e = t; e < (long long)nr * w; e += kPfThreads)
    work[e] = P[(long long)r0 * w + e];
  for (int e = t; e < w * w; e += kPfThreads) Tcm[e] = 0.f;
  __syncthreads();

  // Partial (sum of x_i^2 over own rows i > c, x_c if owned) of column c,
  // by the kPfGroups threads of column c.
  auto norm_partial = [&](int c, int lstart) {
    float tail = 0.f, alpha = 0.f;
    for (int li = lstart + g; li < nr; li += kPfGroups) {
      const float v = work[(long long)li * w + c];
      const int i = r0 + li;
      if (i > c) tail = fmaf(v, v, tail);
      else if (i == c) alpha = v;
    }
    npart[2 * g] = tail;
    npart[2 * g + 1] = alpha;
  };
  auto combine_norm = [&]() {
    if (t == 0) {
      float a = 0.f, b = 0.f;
      for (int q = 0; q < kPfGroups; ++q) {
        a += npart[2 * q];
        b += npart[2 * q + 1];
      }
      nrm[0] = a;
      nrm[1] = b;
    }
  };

  if (k == 0) norm_partial(0, 0);
  __syncthreads();
  combine_norm();

  for (int j = 0; j < w; ++j) {
    const int lstart = max(0, j - r0);
    cluster.sync();  // every CTA's (tail2, alpha) of column j is written
    if (t == 0) {
      float pa[kPfMaxCluster], pb[kPfMaxCluster];
#pragma unroll
      for (int q = 0; q < kPfMaxCluster; ++q) {
        const float* rn = q < csize ? cluster.map_shared_rank(nrm, q) : nrm;
        pa[q] = q < csize ? rn[0] : 0.f;
        pb[q] = q < csize ? rn[1] : 0.f;
      }
      float tail2 = 0.f, alpha = 0.f;
#pragma unroll
      for (int q = 0; q < kPfMaxCluster; ++q) {
        tail2 += pa[q];
        alpha += pb[q];
      }
      const float sigma = sqrtf(fmaf(alpha, alpha, tail2));
      const float sgn = alpha >= 0.f ? 1.f : -1.f;
      const float u = alpha + sgn * sigma;
      const float unorm = sqrtf(fmaf(u, u, tail2));
      const bool live = sigma > 1e-30f;
      const float beta = live ? 2.f : 0.f;
      scal[0] = unorm;
      scal[1] = u;
      scal[2] = live ? 1.f : 0.f;
      scal[3] = beta;
      vdiag[j] = live ? u / unorm : 0.f;
    }
    __syncthreads();
    const float unorm = scal[0], u = scal[1], beta = scal[3];
    const bool live = scal[2] != 0.f;
    for (int li = lstart + t; li < nr; li += kPfThreads) {
      const int i = r0 + li;
      const float x = i == j ? u : work[(long long)li * w + j];
      wv[li] = live ? x / unorm : 0.f;
    }
    __syncthreads();

    // d_k = sum over own rows i >= j of w_i work[i, k], every k < w.
    if (k < w) {
      float acc = 0.f;
      for (int li = lstart + g; li < nr; li += kPfGroups)
        acc = fmaf(wv[li], work[(long long)li * w + k], acc);
      grp[g * kPfCols + k] = acc;
    }
    __syncthreads();
    if (t < w) {
      float s = 0.f;
      for (int q = 0; q < kPfGroups; ++q) s += grp[q * kPfCols + t];
      dpart[t] = s;
    }
    cluster.sync();  // every CTA's partial dots are written
    if (t < w) {
      float pv[kPfMaxCluster];
#pragma unroll
      for (int q = 0; q < kPfMaxCluster; ++q)
        pv[q] = q < csize ? *cluster.map_shared_rank(dpart + t, q) : 0.f;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kPfMaxCluster; ++q) s += pv[q];
      dfull[t] = s;
    }
    __syncthreads();

    // T column j (rank 0): T[i, j] = -beta sum_{i <= k < j} T[i, k] d_k.
    if (rank == 0 && t <= j) {
      if (t < j) {
        float s = 0.f;
        for (int kk = t; kk < j; ++kk) s = fmaf(Tcm[kk * w + t], dfull[kk], s);
        Tcm[j * w + t] = -beta * s;
      } else {
        Tcm[j * w + j] = beta;
      }
    }
    // Rank-1 update of columns k >= j of the live rows; column j below the
    // diagonal becomes V.  Column j + 1's norm partial rides along.
    if (k < w && k >= j) {
      const float dk = dfull[k];
      float tail = 0.f, alpha = 0.f;
      for (int li = lstart + g; li < nr; li += kPfGroups) {
        const int i = r0 + li;
        float* p = work + (long long)li * w + k;
        float v;
        if (k == j && i > j) {
          v = wv[li];
        } else {
          v = *p - beta * (wv[li] * dk);
          if (k == j + 1) {
            if (i > k) tail = fmaf(v, v, tail);
            else if (i == k) alpha = v;
          }
        }
        *p = v;
      }
      if (k == j + 1) {
        npart[2 * g] = tail;
        npart[2 * g + 1] = alpha;
      }
    }
    __syncthreads();
    if (j + 1 < w) combine_norm();
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory

  for (long long e = t; e < (long long)nr * w; e += kPfThreads) {
    const int li = (int)(e / w), c = (int)(e % w);
    const int i = r0 + li;
    const float v = work[e];
    const long long o = (long long)i * w + c;
    R[o] = c >= i ? v : 0.f;
    V[o] = c < i ? v : (c == i ? vdiag[c] : 0.f);
  }
  if (rank == 0)
    for (int e = t; e < w * w; e += kPfThreads)
      Tout[e] = Tcm[(e % w) * w + e / w];
}

}  // namespace mpbqr

extern "C" {

// P (m x w, fp32, row-major, read only; 1 <= w <= 128, m >= w) -> V (m x w),
// T (w x w) and R (m x w, upper triangle), all device pointers, launched on
// `stream` as one cluster.  Returns the launch's CUDA error, or
// cudaErrorInvalidValue for a shape the kernel does not take.
int mpbqr_panel_factor(const float* P, float* V, float* T, float* R, int m,
                       int w, void* stream) {
  using namespace mpbqr;
  if (w < 1 || w > kPfCols || m < w) return (int)cudaErrorInvalidValue;
  int csize = (m + kPfRowsTarget - 1) / kPfRowsTarget;
  csize = csize < 1 ? 1 : (csize > kPfMaxCluster ? kPfMaxCluster : csize);
  const int rows = (m + csize - 1) / csize;
  const long long base = pf_base_floats(w, rows);
  const bool in_smem = (base + (long long)rows * w) * 4 <= kPfSmemLimit;
  const size_t bytes = (size_t)((in_smem ? base + (long long)rows * w : base) * 4);
  if ((long long)bytes > kPfSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      panel_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, 1, 1);
  cfg.blockDim = dim3(kPfThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, panel_factor_kernel, P, V, T, R, m, w, rows,
                           in_smem ? 1 : 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
