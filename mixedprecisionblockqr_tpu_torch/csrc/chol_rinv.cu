// K9: upper Cholesky factor R (G = R^T R) of an SPD r x r fp32 matrix and
// its explicit inverse R^-1, r a multiple of 32, in one launch.
//
// Replaces mixedprecisionblockqr_tpu/ops/pallas/chol.py::chol_rinv
// (pl.pallas_call of _chol_inv_kernel).
//
// The function is the TPU kernel's: right-looking blocked Cholesky on
// 32-wide diagonal blocks, each factored with its inverse by a column loop;
// per block the row-panel solve R[k, k+1:] = Linv A[k, k+1:] and the
// trailing update A -= Rrow^T Rrow; then the block-row back-fill
// Rinv[k, k+1:] = -Rkk^-1 (R[k, k+1:] Rinv[k+1:, k+1:]), k descending.
// Every product is true fp32 FMA; only the summation order differs.
//
// The TPU kernel keeps the whole problem in one core's VMEM.  Here one
// thread-block cluster of C <= 8 CTAs shares the r / 32 column blocks,
// dealt in snake order (0, 1, .., C-1, C-1, .., 0, 0, 1, ..), so that the
// late blocks, whose columns carry the most work in both the update and the
// back-fill, are spread over the CTAs; the layout rule is
// ops/kernels/chol.py::chol_layout.  Each CTA keeps the working copy of its
// columns in its own shared memory (r x 64 floats, 128 KB, at r = 512) or,
// when that does not fit (r > 512), works on them in place in R and Rinv,
// which stay in L2.  Only the block-upper part is live: G is symmetric and
// the update skips the tiles below the diagonal.  Per block k:
//   * the 32 x 32 diagonal factor and its inverse run on one warp in
//     registers (lane j holds column j; the pivot is a shuffle, the column
//     a warp-local broadcast through shared memory; no CTA barrier in the
//     32-step loop; the inverse is the right-looking forward substitution,
//     run in the same loop).  The warp writes Linv^T straight into every
//     CTA's shared memory (distributed shared memory stores);
//   * each CTA solves Rrow = Linv A[k, k+1:] for its own columns and
//     writes it to R (global, through L2);
//   * each CTA reads the Rrow columns it needs from L2 once (Gi) and
//     updates its columns with 4 x 4 register tiles fed by 16-byte
//     shared-memory loads;
//   * look-ahead: the CTA that owns block k+1 updates that diagonal block
//     first; then one warp factors it while its other 15 warps, and the
//     other CTAs, finish block k's update.
// Two cluster barriers per block.  R^-1 is the back-fill, which is local
// to each column once R is complete: each CTA builds Rinv for its own
// column blocks in the same shared memory (or in place in Rinv) with no
// cluster barrier, in 4 x 4 register tiles with the depth split over the
// warps.  utils/chol_phases.py reads the phases' times from the kernel's
// own clock.
//
// What bounds it: the r / 32 diagonal factors and 2 r / 32 cluster
// barriers are a sequence, so the kernel is bound by latency, not by its
// 2 r^3 / 3 fp32 operations or its 12 r^2 bytes.
//
// A pivot that is not positive gives sqrt(negative) = NaN, which spreads
// through the rest of R and R^-1 as in the reference: no error is raised.
// The strictly lower parts of R and R^-1 are exact zeros.  No atomics: the
// result repeats bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace mpbqr {

constexpr int kCB = 32;                 // diagonal block
constexpr int kCholThreads = 512;
constexpr int kCholWarps = kCholThreads / 32;
constexpr int kCholLd = kCB + 4;        // padded 16-byte rows of Lloc
static_assert(kCholThreads == 2 * kCB * 8, "two blocks of 32 x 8 float4s");

// This CTA's column blocks: local block lb is block m C + (c or C-1-c) for
// round m = lb (snake order).  Element (i, jj) of local block lb, row i,
// column 32 block(lb) + jj, is at at(lb)[i * ld + jj].
struct Cols {
  float* base;  // shared memory (blocks side by side) or R / Rinv itself
  int ld, c, C, nbl;
  bool smem;
  __device__ int block(int lb) const {
    return lb * C + ((lb & 1) ? C - 1 - c : c);
  }
  __device__ float* at(int lb) const {
    return base + (smem ? lb : block(lb)) * kCB;
  }
  // First local block whose index is above block k (nbl when none).
  __device__ int live_from(int k) const {
    int lb = 0;
    while (lb < nbl && block(lb) <= k) ++lb;
    return lb;
  }
};

// Phase clocks, compiled in only with -DMPBQR_CHOL_PROF (r <= 512); read by
// utils/chol_phases.py, which names the slots.
#ifdef MPBQR_CHOL_PROF
__device__ unsigned long long g_chol_prof[8][320];
__device__ unsigned long long g_chol_diag[64][2];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PROF(slot) if (threadIdx.x == 0) g_chol_prof[cg::this_cluster().block_rank()][slot] = gtime()
#define PROF_DIAG(e) if ((threadIdx.x & 31) == 0) g_chol_diag[kb / kCB][e] = gtime()
#else
#define PROF(slot)
#define PROF_DIAG(e)
#endif

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Data written by another CTA of the cluster: read at L2, not L1.
__device__ __forceinline__ float4 ld_l2(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4* f4(float* p) {
  return reinterpret_cast<float4*>(p);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// n float4s from L2 (src(e) their addresses) to dst(e, v), by `nthr`
// threads from `tid`, four loads in flight per thread.
template <class Src, class Dst>
__device__ __forceinline__ void stage4(int n, int tid, int nthr, Src src,
                                       Dst dst) {
  for (int e0 = tid; e0 < n; e0 += 4 * nthr) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e0 + u * nthr < n) v[u] = ld_l2(src(e0 + u * nthr));
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e0 + u * nthr < n) dst(e0 + u * nthr, v[u]);
  }
}

// One warp: factor the diagonal block (rows and columns kb..kb+32) whose
// columns start at `blk` (leading dimension ld, row kb at blk[kb * ld]).
// Writes R_kk = L^T over the block (and into R when `r_too`), Linv^T =
// R_kk^-1 into every CTA's Lloc (row-major, ld kCholLd, over distributed
// shared memory) and into Rinv.  Lane j holds column j: a[q] =
// A[kb + i + q][j] at step i (the array shifts up by one per step, so every
// index is a constant), y[q] likewise for column j of Linv, the solution of
// L y = e_j.  Step i's column L[:, i] reaches the lanes through Lcur,
// rotated so that position q holds L[i+1+q][i] (zeros past the block):
// eight broadcast 16-byte loads.  The pivot's reciprocal square root is
// rsqrt with one Newton step (IEEE sqrt and division cost ~190 cycles a
// step on the loop's critical path); each lane sends its four new entries
// of Linv^T as one 16-byte store per CTA every four steps.
__device__ void diag_factor(float* blk, int ld, float* R, float* Rinv, int r,
                            int kb, bool r_too, float* Lloc, float* Lcur) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int j = threadIdx.x & 31;
  blk += (long long)kb * ld;
  PROF_DIAG(0);
  float a[kCB], y[kCB];
#pragma unroll
  for (int q = 0; q < kCB; ++q) {
    a[q] = blk[(long long)q * ld + j];
    y[q] = q == j ? 1.f : 0.f;
  }
#pragma unroll 1
  for (int i0 = 0; i0 < kCB; i0 += 4) {
    float yv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u;
      const float piv = __shfl_sync(0xffffffffu, a[0], i);
      float rd = rsqrtf(piv);
      rd = fmaf(0.5f * rd, fmaf(-piv * rd, rd, 1.f), rd);
      const float col = j >= i ? a[0] * rd : 0.f;  // L[j][i] = R[i][j]
      yv[u] = y[0] * rd;                           // Linv[i][j]
      float* lc = Lcur + (u & 1) * kCB;
      lc[(j - i - 1) & 31] = col;
      blk[(long long)i * ld + j] = col;
      if (r_too) R[(long long)(kb + i) * r + kb + j] = col;
      __syncwarp();
#pragma unroll
      for (int q4 = 0; q4 < kCB / 4; ++q4) {
        const float4 v = ld4(lc + 4 * q4);
        const float l[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int q = 4 * q4 + w;
          if (q + 1 < kCB) {
            a[q] = fmaf(-l[w], col, a[q + 1]);
            y[q] = fmaf(-l[w], yv[u], y[q + 1]);
          }
        }
      }
    }
    const float4 v = make_float4(yv[0], yv[1], yv[2], yv[3]);
    for (int c = 0; c < C; ++c)
      *f4(cluster.map_shared_rank(Lloc + j * kCholLd + i0, c)) = v;
  }
  __syncwarp();
  for (int i = 0; i < kCB; ++i)
    Rinv[(long long)(kb + i) * r + kb + j] = Lloc[i * kCholLd + j];
  PROF_DIAG(1);
}

// All threads: Rrow = Linv A[kb:kb+32, cols] for the columns of local
// blocks lb0.. (all of them above block k), written over those rows of the
// working copy and into R when `r_too`; two blocks per pass.  Lloc holds
// Linv^T.
__device__ void row_solve(const Cols& s, float* R, int r, int kb, bool r_too,
                          int lb0, const float* Lloc) {
  const int tid = threadIdx.x;
  const int p = (tid >> 3) & 31, q = tid & 7;
  for (int lp = lb0; lp < s.nbl; lp += 2) {
    const int lb = lp + (tid >> 8);
    const bool on = lb < s.nbl;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (on) {
      const float* col = s.at(lb) + (long long)kb * s.ld + 4 * q;
#pragma unroll 8
      for (int k = 0; k < kCB; ++k) {
        const float l = Lloc[k * kCholLd + p];  // Linv[p][k]
        const float4 v = ld4(col + (long long)k * s.ld);
        acc.x = fmaf(l, v.x, acc.x);
        acc.y = fmaf(l, v.y, acc.y);
        acc.z = fmaf(l, v.z, acc.z);
        acc.w = fmaf(l, v.w, acc.w);
      }
    }
    __syncthreads();
    if (on) {
      *f4(s.at(lb) + (long long)(kb + p) * s.ld + 4 * q) = acc;
      if (r_too)
        *f4(R + (long long)(kb + p) * r + s.block(lb) * kCB + 4 * q) = acc;
    }
    __syncthreads();
  }
}

// A[i][j] -= sum_p Rrow[p][i] Rrow[p][j] for kb + 32 <= i <= j, j in local
// blocks [lb_lo, lb_hi) (all above block k), Rrow = R[kb:kb+32, :].  The i
// side is staged from L2 into Gi (row p at Gi[p * (chunk + 4)]), `chunk`
// rows at a time; the j side is the working copy's own rows kb..kb+32.  Run
// by `nthr` threads (index `tid`) that synchronise on named barrier `bar`.
__device__ void trailing(const Cols& s, const float* R, int r, int kb,
                         int lb_lo, int lb_hi, float* Gi, int chunk, int tid,
                         int nthr, int bar) {
  const int gld = chunk + 4;
  const int iend = (s.block(lb_hi - 1) + 1) * kCB;
  for (int i0 = kb + kCB; i0 < iend; i0 += chunk) {
    const int ie = min(iend, i0 + chunk);
    const int ni4 = (ie - i0) >> 2;
    stage4(
        kCB * ni4, tid, nthr,
        [&](int e) {
          const int p = e / ni4;
          return R + (long long)(kb + p) * r + i0 + 4 * (e - p * ni4);
        },
        [&](int e, float4 v) {
          const int p = e / ni4;
          *f4(Gi + p * gld + 4 * (e - p * ni4)) = v;
        });
    bar_sync(bar, nthr);
    int base = 0;  // tiles of the earlier blocks, dealt round robin
    for (int lb = lb_lo; lb < lb_hi; ++lb) {
      const int jb = s.block(lb) * kCB;
      const int rows4 = max(0, min(ie, jb + kCB) - i0) >> 2;
      const int n = rows4 * 8;
      float* col = s.at(lb);
      const float* rj = col + (long long)kb * s.ld;
      for (int t = ((tid - base) % nthr + nthr) % nthr; t < n; t += nthr) {
        const int ti = t >> 3, tj = t & 7;
        const int i = i0 + 4 * ti, jj = 4 * tj;
        if (i > jb + jj + 3) continue;  // wholly below the diagonal
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 4
        for (int p = 0; p < kCB; ++p) {
          const float4 u = ld4(Gi + p * gld + 4 * ti);
          const float4 v = ld4(rj + (long long)p * s.ld + jj);
          const float uu[4] = {u.x, u.y, u.z, u.w}, vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(uu[a], vv[b], acc[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float4* o = f4(col + (long long)(i + a) * s.ld + jj);
          float4 w = *o;
          w.x -= acc[a][0];
          w.y -= acc[a][1];
          w.z -= acc[a][2];
          w.w -= acc[a][3];
          *o = w;
        }
      }
      base += n;
    }
    bar_sync(bar, nthr);
  }
}

// All threads, after R is complete: this CTA's columns of Rinv by the
// back-fill, in the working copy t (Rinv_kk on the diagonal blocks, zeros
// below).  Per block row k and pass of up to two local blocks above k:
// S = R[kb:kb+32, rows] Rinv[rows, cols] in 4 x 4 register tiles, lane =
// tile (8 row tiles x 4 column tiles: one 128-byte row of GiT and one
// 64-byte row of Rinv per depth row), warps = 16-column halves x depth
// slices (alternate groups of 4 rows), the slices summed through Gi; then
// Rinv[kb:kb+32, cols] = -Rinv_kk S through Sbuf, one float4 per thread.
// R's rows are staged transposed (GiT[i][p]).  Gi holds at least 8192
// floats (chol_layout), the slices' partial sums.
__device__ void back_fill(const Cols& t, const float* R, const float* Rinv,
                          int r, float* Gi, int chunk, float* Lloc,
                          float* Sbuf) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int top = t.nbl ? t.block(t.nbl - 1) : 0;  // this CTA's last block
  for (int k = top - 1; k >= 0; --k) {
    const int kb = k * kCB, d_lo = kb + kCB;
    PROF(100 + 3 * k);
    // Lloc[q][p] = Rinv_kk[p][q] (= Linv[q][p]): lane p reads a column.
    stage4(
        kCB * kCB / 4, tid, kCholThreads,
        [&](int e) { return Rinv + (long long)(kb + (e >> 3)) * r + kb + 4 * (e & 7); },
        [&](int e, float4 v) {
          float* l = Lloc + 4 * (e & 7) * kCholLd + (e >> 3);
          l[0] = v.x;
          l[kCholLd] = v.y;
          l[2 * kCholLd] = v.z;
          l[3 * kCholLd] = v.w;
        });
    for (int lp = t.live_from(k); lp < t.nbl; lp += 2) {
      const int nl = min(2, t.nbl - lp);    // local blocks in this pass
      const int halves = 2 * nl, slices = kCholWarps / halves;
      const int h = warp % halves, slice = warp / halves;
      const int lb = lp + (h >> 1);
      const int ti = lane >> 2, tj = 4 * (h & 1) + (lane & 3);
      const int bend = (t.block(lb) + 1) * kCB;  // Rinv[i][j] = 0 below
      const int pend = (t.block(lp + nl - 1) + 1) * kCB;
      const float* w = t.at(lb) + 4 * tj;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
      for (int d0 = d_lo; d0 < pend; d0 += chunk) {
        const int de = min(pend, d0 + chunk);
        const int nd4 = (de - d0) >> 2;
        stage4(  // a warp's 32 rows go to 32 banks
            kCB * nd4, tid, kCholThreads,
            [&](int e) {
              return R + (long long)(kb + (e & 31)) * r + d0 + 4 * (e >> 5);
            },
            [&](int e, float4 v) {
              float* g = Gi + 4 * (e >> 5) * kCB + (e & 31);
              g[0] = v.x;
              g[kCB] = v.y;
              g[2 * kCB] = v.z;
              g[3 * kCB] = v.w;
            });
        __syncthreads();
        PROF(101 + 3 * k);
        const int hi = min(de, bend);
        for (int i = d0 + 4 * slice; i < hi; i += 4 * slices) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 g = ld4(Gi + (i + u - d0) * kCB + 4 * ti);
            const float4 v = ld4(w + (long long)(i + u) * t.ld);
            const float gg[4] = {g.x, g.y, g.z, g.w}, vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(gg[a], vv[b], acc[a][b]);
          }
        }
        __syncthreads();
      }
      // Slices 1.. leave their sums in Gi ([slice-1][element][tile]);
      // slice 0 adds them in slice order and writes S into Sbuf.
      const int ntile = 32 * halves, tile = 32 * h + lane;
      if (slice > 0) {
        float* part = Gi + (slice - 1) * 16 * ntile + tile;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) part[(4 * a + b) * ntile] = acc[a][b];
      }
      __syncthreads();
      if (slice == 0) {
        for (int sl = 1; sl < slices; ++sl) {
          const float* part = Gi + (sl - 1) * 16 * ntile + tile;
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] += part[(4 * a + b) * ntile];
        }
        float* sb = Sbuf + 4 * ti * 64 + 32 * (h >> 1) + 4 * tj;
#pragma unroll
        for (int a = 0; a < 4; ++a)
          *f4(sb + a * 64) = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      }
      __syncthreads();
      const int p = tid >> 4, q = tid & 15;  // row p, float4 q of S
      if (q < 8 * nl) {
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
        for (int kk = 0; kk < kCB; ++kk) {
          const float l = Lloc[kk * kCholLd + p];  // Rinv_kk[p][kk]
          const float4 v = ld4(Sbuf + kk * 64 + 4 * q);
          o.x = fmaf(l, v.x, o.x);
          o.y = fmaf(l, v.y, o.y);
          o.z = fmaf(l, v.z, o.z);
          o.w = fmaf(l, v.w, o.w);
        }
        *f4(t.at(lp + (q >> 3)) + (long long)(kb + p) * t.ld + 4 * (q & 7)) =
            make_float4(-o.x, -o.y, -o.z, -o.w);
      }
      __syncthreads();
    }
    PROF(102 + 3 * k);
  }
}

__global__ void __launch_bounds__(kCholThreads, 1)
chol_rinv_kernel(const float* __restrict__ G, float* R, float* Rinv, int r,
                 int stripe, int chunk, int in_smem) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  // The carve-out that chol.py::chol_layout sizes (_BASE_FLOATS: Lloc,
  // Lcur and Sbuf; then Gi and the columns).
  float* Lloc = smem;                   // Linv of the current block
  float* Lcur = Lloc + kCB * kCholLd;   // the diagonal warp's column, x2
  float* Sbuf = Lcur + 2 * kCB;         // back-fill sums of one pass
  float* Gi = Sbuf + kCB * 64;          // staged rows of R
  float* sw = Gi + kCB * (chunk + 4);   // the columns (shared-memory route)
  const int nb = r / kCB;
  const bool r_too = in_smem;  // the working copy is not R itself

  Cols s;
  s.c = rank;
  s.C = C;
  s.smem = in_smem;
  s.base = in_smem ? sw : R;
  s.ld = in_smem ? stripe : r;
  s.nbl = 0;
  while (s.nbl < stripe / kCB && s.block(s.nbl) < nb) ++s.nbl;

  PROF(0);
  // Working copy: G's block-upper part of this CTA's columns; exact zeros
  // in R's block-lower part.
  // (Rows below a block's end are read and dropped: G is symmetric.)
  stage4(
      s.nbl * r * 8, tid, kCholThreads,
      [&](int e) {
        const int lb = e / (r * 8), rem = e - lb * (r * 8);
        return G + (long long)(rem >> 3) * r + s.block(lb) * kCB + 4 * (rem & 7);
      },
      [&](int e, float4 v) {
        const int lb = e / (r * 8), rem = e - lb * (r * 8);
        const int i = rem >> 3, jj = 4 * (rem & 7), b = s.block(lb);
        if (i >= (b + 1) * kCB) {
          v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (in_smem) *f4(R + (long long)i * r + b * kCB + jj) = v;
        }
        *f4(s.at(lb) + (long long)i * s.ld + jj) = v;
      });
  cluster.sync();  // every CTA runs before the first DSMEM write
  PROF(1);

  // Block b belongs to CTA owner(b), as its local block b / C.
  auto owner = [C](int b) {
    const int m = b / C, pos = b - m * C;
    return (m & 1) ? C - 1 - pos : pos;
  };
  if (rank == 0 && tid < kCB)
    diag_factor(s.at(0), s.ld, R, Rinv, r, 0, r_too, Lloc, Lcur);
  for (int k = 0; k < nb; ++k) {
    const int kb = k * kCB;
    cluster.sync();  // Linv of block k is in every CTA's Lloc
    PROF(2 + 4 * k);
    const int lb0 = s.live_from(k);  // local blocks right of block k
    if (lb0 < s.nbl) row_solve(s, R, r, kb, r_too, lb0, Lloc);
    PROF(3 + 4 * k);
    if (k + 1 == nb) break;
    cluster.sync();  // every CTA's Rrow of block k is in R
    PROF(4 + 4 * k);
    if (lb0 < s.nbl) {
      if (owner(k + 1) == rank) {
        // Look-ahead: block k+1's diagonal block (local block lb0) first;
        // then one warp factors it while the other warps update the rest.
        trailing(s, R, r, kb, lb0, lb0 + 1, Gi, chunk, tid, kCholThreads, 0);
        if (tid < kCB)
          diag_factor(s.at(lb0), s.ld, R, Rinv, r, kb + kCB, r_too, Lloc,
                      Lcur);
        else if (lb0 + 1 < s.nbl)
          trailing(s, R, r, kb, lb0 + 1, s.nbl, Gi, chunk, tid - kCB,
                   kCholThreads - kCB, 1);
        __syncthreads();
      } else {
        trailing(s, R, r, kb, lb0, s.nbl, Gi, chunk, tid, kCholThreads, 0);
      }
    }
    PROF(5 + 4 * k);
  }
  cluster.sync();  // R and every Rinv_kk written; no DSMEM reads after this
  PROF(300);

  // R^-1, local to this CTA's columns: Rinv_kk on the diagonal blocks,
  // zeros elsewhere, then the back-fill fills the block-upper part.
  Cols t = s;
  t.base = in_smem ? sw : Rinv;
  for (int e = tid; e < t.nbl * r * 8; e += kCholThreads) {
    const int lb = e / (r * 8), rem = e - lb * (r * 8);
    const int i = rem >> 3, jj = 4 * (rem & 7);
    const int b = t.block(lb);
    float* o = t.at(lb) + (long long)i * t.ld + jj;
    if (i / kCB == b) {
      if (in_smem) *f4(o) = ld_l2(Rinv + (long long)i * r + b * kCB + jj);
    } else {
      *f4(o) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();
  back_fill(t, R, Rinv, r, Gi, chunk, Lloc, Sbuf);
  PROF(301);
  if (in_smem) {
    for (int e = tid; e < t.nbl * r * 8; e += kCholThreads) {
      const int lb = e / (r * 8), rem = e - lb * (r * 8);
      const int i = rem >> 3, jj = 4 * (rem & 7);
      *f4(Rinv + (long long)i * r + t.block(lb) * kCB + jj) =
          ld4(t.at(lb) + (long long)i * t.ld + jj);
    }
  }
}

}  // namespace mpbqr

extern "C" {

#ifdef MPBQR_CHOL_PROF
// Copy the phase clocks (8 x 320 and 64 x 2 unsigned 64-bit) to the host.
int mpbqr_chol_prof(unsigned long long* prof, unsigned long long* diag) {
  cudaError_t e = cudaMemcpyFromSymbol(prof, mpbqr::g_chol_prof, sizeof(mpbqr::g_chol_prof));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(diag, mpbqr::g_chol_diag, sizeof(mpbqr::g_chol_diag));
}
#endif

// G (r x r, fp32, row-major, read only) -> R and Rinv (r x r each), device
// pointers, one cluster launch on `stream` with the layout that
// ops/kernels/chol.py::chol_layout gives r: ceil(r / stripe) CTAs, each
// holding `stripe` columns, R's rows staged `chunk` at a time, the columns
// in shared memory when `in_smem`, else in place in R and Rinv, and
// `smem_bytes` of dynamic shared memory per CTA.  The layout is not checked
// here: a cluster or a shared-memory size the card refuses comes back as
// the launch's CUDA error.
int mpbqr_chol_rinv(const float* G, float* R, float* Rinv, int r, int stripe,
                    int chunk, int in_smem, int smem_bytes, void* stream) {
  using namespace mpbqr;
  const int csize = (r + stripe - 1) / stripe;
  cudaError_t err = cudaFuncSetAttribute(
      chol_rinv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, 1, 1);
  cfg.blockDim = dim3(kCholThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, chol_rinv_kernel, G, R, Rinv, r, stripe,
                           chunk, in_smem ? 1 : 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
