// K7: greedy QRCP pivot selection on a small (d x w) sketch -- r classical
// Gram-Schmidt pivot steps in one kernel launch.
//
// Replaces mixedprecisionblockqr_tpu/ops/pallas/sketch.py::sketch_qrcp_ranks
// (_sketch_qrcp_ranks_padded -> pl.pallas_call of _sketch_qrcp_kernel).
//
// The TPU kernel keeps the whole sketch in VMEM (136 x 2048 fp32 = 1.1 MB
// at the RQRCP panels' first step), which no SM holds.  Here one
// thread-block cluster of C <= 8 CTAs splits the w columns into C
// contiguous stripes; the layout rule is ops/kernels/sketch.py::
// sketch_layout.  A column is ldc = 4 ceil(d / 4) floats (the rows past d
// zero), handled by a group of tpc threads, each holding up to kSkChunks
// float4 chunks of it in registers (136 rows: 8 threads of 5 chunks).
// Each CTA keeps its stripe, column by column, in its own shared memory
// (8 stripes of 256 columns, 139 KB each, at 136 x 2048) or, when that
// does not fit, in place in the `work` scratch, which stays in L2: one
// base pointer chooses the route.  The norms and qn stay in shared memory.
// Per step s:
//   * warp 0 of every CTA reads the 8 x 16 candidate keys (one per warp;
//     see key()) that the warps pushed into its shared memory before the
//     step's one cluster barrier, and makes the same argmax, so every CTA
//     finds the same pivot j with no second exchange; a NaN, or no
//     candidate, ends the selection for good (the state no longer changes);
//   * it reads column j from its owner (distributed shared memory, or L2
//     on the in-place route), scales it in the same order as every other
//     CTA, so qn agrees bit for bit, and leaves qn in shared memory.  A
//     selected column is dead and never written again, which makes that
//     read safe: no second barrier and no pushed column are needed;
//   * after one CTA barrier, one pass over the stripe computes each live
//     column's coefficient (its thread group's partial sums and a shuffle
//     reduction, so the coefficient stays in registers), its downdate, its
//     norm update and the warp's best key, which the warp pushes into every
//     CTA's shared memory (double-buffered by step parity); then the
//     cluster barrier.
//
// What bounds it: the r steps are a strict sequence, each one cluster
// barrier, one CTA barrier, a remote read of d floats and a pass of
// 4 d w / C operations per CTA; the kernel is bound by that latency, not by
// its 4 r d w fp32 operations or its 4 (d w + w) bytes.
// utils/sketch_probe.py --phases reads the phases' times from the kernel's
// own clock.
//
// Per step s (the JAX kernel's semantics):
//   j     = first index of max(norms); a NaN max selects nothing;
//   qn    = q / ||q|| for the pivot column q (0 when ||q||^2 <= tiny);
//   coef  = qn^T work;  work -= qn coef;
//   norms = max(norms - coef^2, 0), the pivot and dead columns at -inf;
//   rank[j] = s.
// Products are fp32 FMA; the downdates round the product before the
// subtraction, as the plain version does.  Dead columns are not downdated
// (their values are never read again).  No atomics: the result repeats
// bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSkThreads = 512;
constexpr int kSkWarps = kSkThreads / 32;
constexpr int kSkMaxCluster = 8;
constexpr int kSkChunks = 5;  // float4 chunks of a column per thread
// Floats of shared memory before the pivot column: the candidates (2
// parities x 8 CTAs x 16 warps of a 64-bit key) and the pivot's index
// (2 parities, padded to 16 bytes).
constexpr int kSkBaseFloats = 2 * kSkMaxCluster * kSkWarps * 2 + 4;

// Per-CTA clock64 sums of a launch's step phases, compiled in only with
// -DMPBQR_SKETCH_PROF; read by utils/sketch_probe.py --phases, which names
// the slots.
#ifdef MPBQR_SKETCH_PROF
__device__ long long g_sk_prof[kSkMaxCluster][8];
#define PROF_INIT long long pt = clock64(), pacc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#define PROF(k) if (tid == 0) { const long long t = clock64(); pacc[k] += t - pt; pt = t; }
#define PROF_SAVE if (tid == 0) for (int k = 0; k < 8; ++k) g_sk_prof[cr][k] = pacc[k];
#else
#define PROF_INIT
#define PROF(k)
#define PROF_SAVE
#endif

__device__ __forceinline__ float nan_max0(float a) {
  // max(a, 0) that propagates NaN, as jnp.maximum (fmaxf drops NaN).
  return (a != a) ? a : fmaxf(a, 0.f);
}

// A candidate (norm v, column i) as a 64-bit key whose maximum is the
// first index of the largest norm, or a NaN when there is one: the high
// word orders the floats (a NaN above everything), the low word is ~i.
__device__ __forceinline__ unsigned long long key(float v, int i) {
  unsigned hi = __float_as_uint(v + 0.f);  // -0 as +0
  hi = v != v ? 0xffffffffu : (hi & 0x80000000u) ? ~hi : hi | 0x80000000u;
  return ((unsigned long long)hi << 32) | (unsigned)~i;
}
constexpr unsigned long long kNoKey = 0ull;  // below every candidate
__device__ __forceinline__ bool key_nan(unsigned long long k) {
  return (unsigned)(k >> 32) == 0xffffffffu;
}
__device__ __forceinline__ int key_index(unsigned long long k) {
  return (int)~(unsigned)k;  // -1 for kNoKey
}

// The warp's largest key, in every lane.
__device__ __forceinline__ unsigned long long warp_max(unsigned long long k) {
  const unsigned hi = __reduce_max_sync(0xffffffffu, (unsigned)(k >> 32));
  const unsigned lo = __reduce_max_sync(
      0xffffffffu, (unsigned)(k >> 32) == hi ? (unsigned)k : 0u);
  return ((unsigned long long)hi << 32) | lo;
}

__global__ void __launch_bounds__(kSkThreads, 1)
sketch_qrcp_kernel(const float* __restrict__ B, float* work,
                   int* __restrict__ rank, int d, int w, int r, int stripe,
                   int in_smem) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cr = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // tpc is the least power of two (32 at most) whose threads hold a column
  // in kSkChunks chunks each; taller columns go in row blocks of blk
  // chunks.  Chunk t of row block kb of a thread is kb + p + tpc t.
  const int nv4 = (d + 3) >> 2, ldc = 4 * nv4;
  int tpc = 1;
  while (tpc < 32 && tpc * kSkChunks < nv4) tpc *= 2;
  const int blk = tpc * kSkChunks;
  const int last = (nv4 - 1) / blk * blk;  // the last row block's first chunk
  const int G = kSkThreads / tpc;  // column groups; this thread's is g
  const int g = tid / tpc, p = tid % tpc;
  // The carve-out that sketch.py::sketch_layout sizes.
  unsigned long long* cand =  // [2][8 CTAs x 16 warps] candidate keys
      reinterpret_cast<unsigned long long*>(smem);
  int* s_j = reinterpret_cast<int*>(smem + kSkBaseFloats - 4);  // [2]
  float* qbuf = smem + kSkBaseFloats;  // the pivot column qn, ldc
  float* norms = qbuf + ldc;           // stripe
  float* slice = norms + ((stripe + 3) & ~3);  // stripe x ldc
  const float4* q4 = reinterpret_cast<const float4*>(qbuf);

  const int col0 = cr * stripe;
  const int ncols = max(0, min(stripe, w - col0));
  // Column c of this stripe at S + c * ldc: shared memory or the scratch.
  float* S = in_smem ? slice : work + (long long)col0 * ldc;
  auto col = [&](int cl) {
    return reinterpret_cast<float4*>(S + (long long)cl * ldc);
  };
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int e = tid; e < ncols * ldc; e += kSkThreads) {
    const int i = e / ncols, c = e - i * ncols;
    S[(long long)c * ldc + i] = i < d ? B[(long long)i * w + col0 + c] : 0.f;
  }
  for (int c = tid; c < ncols; c += kSkThreads) rank[col0 + c] = w;
  __syncthreads();
  cluster.sync();  // every CTA runs before the first DSMEM write
  PROF_INIT

  // This thread's chunks of row block kb of column v (zeros past the end)
  // into a, and the store of x.
  float4 x[kSkChunks], q[kSkChunks];
  auto load = [&](const float4* v, int kb, float4 (&a)[kSkChunks]) {
#pragma unroll
    for (int t = 0; t < kSkChunks; ++t) {
      const int k = kb + p + tpc * t;
      a[t] = k < nv4 ? v[k] : zero4;
    }
  };
  auto store = [&](float4* v, int kb) {
#pragma unroll
    for (int t = 0; t < kSkChunks; ++t) {
      const int k = kb + p + tpc * t;
      if (k < nv4) v[k] = x[t];
    }
  };
  // The thread's part of a^T x over a row block, and the downdate
  // x -= q cf.
  auto dot = [&](const float4 (&a)[kSkChunks], float acc) {
#pragma unroll
    for (int t = 0; t < kSkChunks; ++t) {
      acc = fmaf(a[t].x, x[t].x, acc);
      acc = fmaf(a[t].y, x[t].y, acc);
      acc = fmaf(a[t].z, x[t].z, acc);
      acc = fmaf(a[t].w, x[t].w, acc);
    }
    return acc;
  };
  auto downdate = [&](float cf) {
#pragma unroll
    for (int t = 0; t < kSkChunks; ++t) {
      x[t].x = __fsub_rn(x[t].x, __fmul_rn(q[t].x, cf));
      x[t].y = __fsub_rn(x[t].y, __fmul_rn(q[t].y, cf));
      x[t].z = __fsub_rn(x[t].z, __fmul_rn(q[t].z, cf));
      x[t].w = __fsub_rn(x[t].w, __fmul_rn(q[t].w, cf));
    }
  };
  // The group's sum, in every lane of the group.
  auto group_sum = [&](float acc) {
    for (int o = tpc >> 1; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    return acc;
  };
  // The warp's best key into every CTA's slot [par][cr][warp], then the
  // cluster barrier, which also ends the pass in this CTA.
  auto push = [&](unsigned long long best, int par) {
    best = warp_max(best);
    if (lane < C)
      *cluster.map_shared_rank(
          cand + par * (kSkMaxCluster * kSkWarps) + cr * kSkWarps + warp,
          lane) = best;
    PROF(5);
    cluster.sync();
    PROF(7);
  };

  // The initial norms.
  {
    unsigned long long best = kNoKey;
    for (int c0 = 0; c0 < ncols; c0 += G) {
      const int cl = c0 + g;
      float acc = 0.f;
      if (cl < ncols)
        for (int kb = 0; kb <= last; kb += blk) {
          load(col(cl), kb, x);
          acc = dot(x, acc);
        }
      const float nn = group_sum(acc);
      if (cl < ncols) {
        if (p == 0) norms[cl] = nn;
        best = max(best, key(nn, col0 + cl));
      }
    }
    push(best, 0);
  }

  for (int step = 0; step < r; ++step) {
    const int par = step & 1;
    if (warp == 0) {
      // The pivot: the same argmax of the same candidates in every CTA.
      const unsigned long long* cp = cand + par * (kSkMaxCluster * kSkWarps);
      unsigned long long best = kNoKey;
#pragma unroll
      for (int t = 0; t < kSkMaxCluster * kSkWarps / 32; ++t) {
        const int k = lane + 32 * t;
        if (k < C * kSkWarps) best = max(best, cp[k]);
      }
      best = warp_max(best);
      const int j = key_nan(best) ? -1 : key_index(best);
      PROF(0);
      if (j >= 0) {
        // Column j from its owner, its norm in the same order in every
        // CTA, and qn into qbuf.
        const int owner = j / stripe, jl = j - owner * stripe;
        const float4* src = reinterpret_cast<const float4*>(
            in_smem ? cluster.map_shared_rank(slice, owner) + jl * ldc
                    : work + (long long)j * ldc);
        float4* dst = reinterpret_cast<float4*>(qbuf);
        float s2 = 0.f;
        for (int kb = 0; kb < nv4; kb += 64) {
          const int k0 = kb + lane, k1 = k0 + 32;
          float4 a = zero4, b = zero4;
          if (k0 < nv4) a = in_smem ? src[k0] : __ldcg(src + k0);
          if (k1 < nv4) b = in_smem ? src[k1] : __ldcg(src + k1);
          s2 = fmaf(a.x, a.x, s2);
          s2 = fmaf(a.y, a.y, s2);
          s2 = fmaf(a.z, a.z, s2);
          s2 = fmaf(a.w, a.w, s2);
          s2 = fmaf(b.x, b.x, s2);
          s2 = fmaf(b.y, b.y, s2);
          s2 = fmaf(b.z, b.z, s2);
          s2 = fmaf(b.w, b.w, s2);
          if (k0 < nv4) dst[k0] = a;
          if (k1 < nv4) dst[k1] = b;
        }
        PROF(1);
        for (int o = 16; o > 0; o >>= 1)
          s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        const float sc = 1.0f / sqrtf(fmaxf(s2, FLT_MIN));
        const bool big = s2 > FLT_MIN;
        for (int k = lane; k < nv4; k += 32) {
          const float4 a = dst[k];
          dst[k] = big ? make_float4(a.x * sc, a.y * sc, a.z * sc, a.w * sc)
                       : zero4;
        }
      }
      if (lane == 0) s_j[par] = j;
      PROF(2);
    }
    __syncthreads();
    const int j = s_j[par];
    if (j < 0) break;  // the same decision in every CTA

    // The pass.  qn's chunks stay in registers for the whole pass when a
    // column is one row block; a column's last row block read stays in
    // registers from its coefficient to its downdate, and earlier row
    // blocks of a tall column are read again.
    unsigned long long best = kNoKey;
    load(q4, last, q);
    for (int c0 = 0; c0 < ncols; c0 += G) {
      const int cl = c0 + g;
      const bool have = cl < ncols;
      const float nv = have ? norms[cl] : -INFINITY;
      const bool live = have && nv != -INFINITY && col0 + cl != j;
      float acc = 0.f;
      if (live)
        for (int kb = last; kb >= 0; kb -= blk) {
          if (last > 0) load(q4, kb, q);
          load(col(cl), kb, x);
          acc = dot(q, acc);
        }
      const float cf = group_sum(acc);
      float nn = -INFINITY;  // the pivot and dead columns
      if (live) {
        downdate(cf);
        store(col(cl), 0);
        for (int kb = blk; kb <= last; kb += blk) {
          load(q4, kb, q);
          load(col(cl), kb, x);
          downdate(cf);
          store(col(cl), kb);
        }
        nn = nan_max0(__fsub_rn(nv, __fmul_rn(cf, cf)));
      }
      if (have) {
        if (p == 0) {
          norms[cl] = nn;
          if (col0 + cl == j) rank[j] = step;
        }
        best = max(best, key(nn, col0 + cl));
      }
    }
    PROF(4);
    push(best, par ^ 1);
  }
  PROF_SAVE
}

}  // namespace

extern "C" {

#ifdef MPBQR_SKETCH_PROF
// Copy the phase clocks (8 x 8 signed 64-bit) to the host.
int mpbqr_sketch_prof(long long* prof) {
  return (int)cudaMemcpyFromSymbol(prof, g_sk_prof, sizeof(g_sk_prof));
}
#endif

// B (d x w, fp32, row-major, read only) -> rank (w, int32): the s-th pivot
// holds s, unselected columns hold w.  work (w x 4 ceil(d / 4) floats, the
// sketch column by column) is the in-place route's scratch, unused on the
// shared-memory route.  All device pointers; one cluster launch of
// `cluster` CTAs on `stream` with the layout that
// ops/kernels/sketch.py::sketch_layout gives (d, w): each CTA holds
// `stripe` columns (the last may hold fewer), in its shared memory when
// `in_smem`, else in place in work, with `smem_bytes` of dynamic shared
// memory.  The layout is not checked here: a cluster or a shared-memory
// size the card refuses comes back as the launch's CUDA error.
int mpbqr_sketch_qrcp(const float* B, float* work, int* rank, int d, int w,
                      int r, int cluster, int stripe, int in_smem,
                      int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sketch_qrcp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kSkThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sketch_qrcp_kernel, B, work, rank, d, w, r,
                           stripe, in_smem ? 1 : 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
