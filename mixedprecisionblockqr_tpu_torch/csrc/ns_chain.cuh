// Device-side triangular Newton-Schulz chain shared by the ns_chain (K1),
// bgs_group_fused (K2, K5) and panel_qr_fused (K3) kernels.
//
// Replaces the in-kernel chain of mixedprecisionblockqr_tpu/ops/pallas/ns.py
// (_tri_ns, _norm2_est, _ns_kernel).
//
// What bounds it on this card: the chain is a strictly sequential string of
// r x r products (three per iteration), each far too small to fill the card,
// so its time is the latency of one product times their number, not
// operations or bytes.  The design therefore shortens each product and keeps
// everything between products on chip:
//   * One thread-block cluster of r / 16 CTAs (8 at r = 128) runs one chain.
//     Each CTA owns 16 rows of X and W = G X and the same 16 columns of
//     T = X^T W, E = I - T and the correction C: 8 from the top and 8 from
//     the bottom, so that all CTAs hold the same share of the triangular X
//     and C.
//   * Every operand lives in shared memory.  The two operands that a
//     product needs whole (X and C) are replicated in every CTA and
//     refreshed by an all-gather: each owner writes its stripe into all
//     CTAs' copies through distributed shared memory, 16 bytes a store
//     (the zeros beyond the diagonal are not sent: the cluster's network,
//     at some 10 bytes a clock and SM, is what an iteration waits for
//     most), and a cluster barrier separates dependent products (two per
//     fused iteration, three per classic one).  Nothing goes through
//     global scratch.
//   * Every product has the form D[p][q] = <P[p, :], Q[q, :]> with P one of
//     the replicated operands, stored transposed (X^T, C^T) so that both
//     operands are contiguous along the summed index, and Q a 16-row stripe
//     (own rows of X, W or G, or the gathered 16 columns of W or G).  X and
//     C are upper triangular, so row p of P sums k <= p only: half the work,
//     balanced by pairing row p with row r - 1 - p.
//   * The split products (the emulated Precision.HIGH of the chain_mid
//     iterations) run on the tensor cores: the replicated operand is split
//     into bf16 hi / lo once, by its owner, as it is gathered; the stripe
//     operand is split in registers; hi*hi + hi*lo + lo*hi are three
//     mma.sync m16n8k16 bf16 products into one fp32 accumulator.  Each
//     bf16 x bf16 product is exact in fp32, so only the order of the fp32
//     sum differs from the FMA form.
//   * The fp32 products (Precision.HIGHEST: the two closing iterations,
//     refine chains, the exact residual and t = X^T G') stay true fp32 FMA,
//     never TF32 and never a bf16 split, as 16-byte shared-memory loads of
//     both operands along k.
//   * The Jacobi scaling, the spectral guard and the shift's norm estimate
//     are computed redundantly by every CTA from a shared-memory copy of G
//     (the same arithmetic in the same order, so all CTAs agree bitwise and
//     need no exchange).
// NaN survives every reduction (nan_max), across the cluster as well: the
// callers' poison canary depends on it.  Two launches on the same input give
// the same bits: no atomics, every reduction in a fixed order.
//
// The general (not triangular) fp32 product prod_gen, the cp.async loads
// of a whole replicated operand and the cluster launch below also run
// ninv_chain.cu (K4) and panel.cuh's combine.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace mpbqr {

namespace cg = cooperative_groups;

constexpr int kChainThreads = 256;
constexpr int kStripe = 16;  // rows of every chain matrix that one CTA owns

// How a chain kernel reports its residual max|E| (ns.py:715-727):
// raw, squared (plain chains, one step behind) or x 1e-2 (robust chains).
enum { RESID_RAW = 0, RESID_SQUARE = 1, RESID_SCALE = 2 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// NaN-propagating max, as jnp.maximum / jnp.max: the poison canary depends
// on a NaN residual surviving every reduction.
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  return fmaxf(a, b);
}

// Block-wide reductions over kChainThreads threads; `red` holds >= 32 floats.
__device__ __forceinline__ float blk_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) red[w] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
    red[0] = s;
  }
  __syncthreads();
  s = red[0];
  __syncthreads();
  return s;
}

__device__ __forceinline__ float blk_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) red[w] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = red[0];
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i) s = nan_max(s, red[i]);
    red[0] = s;
  }
  __syncthreads();
  const float s = red[0];
  __syncthreads();
  return s;
}

// -- the cluster chain -----------------------------------------------------

// Dynamic shared memory of one chain CTA.  Row pitches are padded so that
// the fragment and 16-byte loads below spread over the banks and every row
// starts 16-byte aligned.
template <int R>
struct ChainLayout {
  static constexpr int CS = R / kStripe;  // CTAs of the cluster
  static constexpr int LDF = R + 4;       // fp32 row pitch, floats
  static constexpr int LDH = R + 8;       // bf16 row pitch, elements
  // A replicated operand: fp32 [R][LDF], or bf16 hi [R][LDH] then lo.
  static constexpr int FULL_BYTES =
      (R * LDF * 4 > 4 * R * LDH) ? R * LDF * 4 : 4 * R * LDH;
  static constexpr int STRIPE_BYTES = kStripe * LDF * 4;
  static constexpr int OFF_X = 0;                      // X^T, replicated
  static constexpr int OFF_C = FULL_BYTES;             // C^T, replicated
  static constexpr int OFF_XS = 2 * FULL_BYTES;        // own rows of X
  static constexpr int OFF_WS = OFF_XS + STRIPE_BYTES;  // own rows of W
  static constexpr int OFF_GS = OFF_WS + STRIPE_BYTES;  // own rows of G'
  // 16 gathered columns, transposed: of W (for T), of C (staging), of G'.
  static constexpr int OFF_QC = OFF_GS + STRIPE_BYTES;
  static constexpr int OFF_VEC = OFF_QC + STRIPE_BYTES;  // d, v0, v1, red, cred
  static constexpr int BYTES = OFF_VEC + (3 * R + 32 + 32) * 4;
};

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo_k,
                                              __nv_bfloat16 hi_k) {
  return (uint32_t)__bfloat16_as_ushort(lo_k) |
         ((uint32_t)__bfloat16_as_ushort(hi_k) << 16);
}

// Two-term bf16 split of a pair (ns.py::_split_bf16): hi = bf16(x),
// lo = bf16(x - hi); the lower 16 bits hold the first element.
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 xh = __float2bfloat16_rn(x), yh = __float2bfloat16_rn(y);
  hi = pack_bf16(xh, yh);
  lo = pack_bf16(__float2bfloat16_rn(x - __bfloat162float(xh)),
                 __float2bfloat16_rn(y - __bfloat162float(yh)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D[p][q] = sum_k P[p][k] Q[q][k] in true fp32 FMA, k ascending.  P is
// [R][LDF], Q is [16][LDF], both in shared memory.  P is lower triangular
// (X^T and C^T are: P[p][k] == 0 for k > p), so row p sums k <= p only, and
// a thread pairs row pw with row R - 1 - pw so that all threads do the same
// work.  epi(p, q, value) runs once per element of D, after a block barrier
// when `sync` (for epilogues that overwrite an operand).
template <int R, class Epi>
__device__ __forceinline__ void prod_f32(const float* P, const float* Q,
                                         bool sync, Epi epi) {
  using L = ChainLayout<R>;
  constexpr int HP = R / 2;                // threads along p; each takes 2
  constexpr int QG = kChainThreads / HP;   // threads along q
  constexpr int QPT = kStripe / QG;        // q's per thread
  const int pw = threadIdx.x / QG, qq = threadIdx.x % QG;
  const int pa = pw, pb = R - 1 - pw;      // pa < pb
  float acc[2][QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) acc[0][j] = acc[1][j] = 0.f;
  const float4* p0 = reinterpret_cast<const float4*>(P + pa * L::LDF);
  const float4* p1 = reinterpret_cast<const float4*>(P + pb * L::LDF);
  const float4* qb = reinterpret_cast<const float4*>(Q + qq * L::LDF);
  constexpr int QSTEP = QG * L::LDF / 4;   // float4s between a thread's q's
  const int na = pa / 4 + 1, nb = pb / 4 + 1;
#pragma unroll 4
  for (int k4 = 0; k4 < na; ++k4) {
    const float4 a0 = p0[k4], a1 = p1[k4];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const float4 b = qb[j * QSTEP + k4];
      acc[0][j] = fmaf(a0.x, b.x, acc[0][j]);
      acc[0][j] = fmaf(a0.y, b.y, acc[0][j]);
      acc[0][j] = fmaf(a0.z, b.z, acc[0][j]);
      acc[0][j] = fmaf(a0.w, b.w, acc[0][j]);
      acc[1][j] = fmaf(a1.x, b.x, acc[1][j]);
      acc[1][j] = fmaf(a1.y, b.y, acc[1][j]);
      acc[1][j] = fmaf(a1.z, b.z, acc[1][j]);
      acc[1][j] = fmaf(a1.w, b.w, acc[1][j]);
    }
  }
#pragma unroll 4
  for (int k4 = na; k4 < nb; ++k4) {
    const float4 a1 = p1[k4];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const float4 b = qb[j * QSTEP + k4];
      acc[1][j] = fmaf(a1.x, b.x, acc[1][j]);
      acc[1][j] = fmaf(a1.y, b.y, acc[1][j]);
      acc[1][j] = fmaf(a1.z, b.z, acc[1][j]);
      acc[1][j] = fmaf(a1.w, b.w, acc[1][j]);
    }
  }
  if (sync) __syncthreads();
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    epi(pa, qq + QG * j, acc[0][j]);
    epi(pb, qq + QG * j, acc[1][j]);
  }
}

// The general (not triangular) D[p][q] = sum_k P[p][k] Q[q][k] of K4 and
// the R-block combine, in true fp32 FMA; P [R][LDF] and Q [16][LDF] in
// shared memory as for prod_f32.  What bounds it is the shared memory's
// 128 bytes a clock, not the FMA rate: measured, prod_f32's form runs as if
// a 16-byte load cost a warp four wavefronts whatever it broadcasts.  So
// each thread keeps a 4-row x 4-q tile (R / 32 rows at R < 128): 8 loads
// a k-quad for 64 FMA, against prod_f32's 6 for 32.  The 128 threads that
// cover D take half of k each, twice over: threads 128..255 sum the upper
// half of k and leave their partial sums in `part` (kGenPart<R> floats),
// which threads 0..127 add to their own after a block barrier, so every
// element is (lower half, k ascending) + (upper half, k ascending), the
// same bits every launch.
// epi(p, q, value) runs once per element of D, on threads 0..127, after
// that barrier: an epilogue may overwrite P or Q.  Two calls that share
// `part` need a block barrier between them.
template <int R>
constexpr int kGenPart = 128 * (R / 32) * 4;

template <int R, class Epi>
__device__ __forceinline__ void prod_gen(const float* P, const float* Q,
                                         float* part, Epi epi) {
  using L = ChainLayout<R>;
  constexpr int RP = R / 32;           // rows per thread, 32 apart
  constexpr int K4 = R / 8;            // k-quads per half
  const int h = threadIdx.x >> 7, u = threadIdx.x & 127;
  const int pg = u & 31, qg = u >> 5;  // rows pg + 32 i, q's 4 qg + j
  float acc[RP][4];
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const float4* pr = reinterpret_cast<const float4*>(P + pg * L::LDF) + h * K4;
  const float4* qr =
      reinterpret_cast<const float4*>(Q + 4 * qg * L::LDF) + h * K4;
  constexpr int PSTEP = 32 * L::LDF / 4, QSTEP = L::LDF / 4;
#pragma unroll 2
  for (int k4 = 0; k4 < K4; ++k4) {
    float4 a[RP], b[4];
#pragma unroll
    for (int i = 0; i < RP; ++i) a[i] = pr[i * PSTEP + k4];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = qr[j * QSTEP + k4];
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
  if (h == 1) {
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[(i * 4 + j) * 128 + u] = acc[i][j];
  }
  __syncthreads();
  if (h == 0) {
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        epi(pg + 32 * i, 4 * qg + j, acc[i][j] + part[(i * 4 + j) * 128 + u]);
  }
}

// The same D with both operands split into bf16 hi + lo and the three
// products hi*hi + hi*lo + lo*hi on the tensor cores.  Ph / Pl are the
// pre-split halves of P, [R][LDH] bf16 each; Q is fp32 [16][LDF], split in
// registers.  P is the mma's A operand (a 16-row tile a unit), Q its B
// operand (an 8-row tile a unit).  P is lower triangular, so tile mt takes
// the k-steps 0 .. mt only; at R = 128 a warp takes the units (mt = warp,
// first 8 q's) and (mt = 7 - warp, last 8 q's): nine k-steps each.
template <int R, class Epi>
__device__ __forceinline__ void prod_split(const __nv_bfloat16* Ph,
                                           const __nv_bfloat16* Pl,
                                           const float* Q, bool sync,
                                           Epi epi) {
  using L = ChainLayout<R>;
  constexpr int MT = R / 16;                     // 16-row tiles of P
  constexpr int NTW = (MT >= 8) ? 2 : 1;         // units per warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int mt[NTW], nt[NTW];
  if (NTW == 2) {
    mt[0] = warp;
    nt[0] = 0;
    mt[NTW - 1] = MT - 1 - warp;
    nt[NTW - 1] = 1;
  } else {
    mt[0] = warp % MT;
    nt[0] = warp / MT;
  }
  const bool active = nt[0] < 2;
  float acc[NTW][4];
#pragma unroll
  for (int u = 0; u < NTW; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[u][c] = 0.f;
  if (active) {
#pragma unroll
    for (int u = 0; u < NTW; ++u) {
      const int r0 = (mt[u] * 16 + g) * L::LDH + 2 * t;
      const uint32_t* ah0 = reinterpret_cast<const uint32_t*>(Ph + r0);
      const uint32_t* ah1 =
          reinterpret_cast<const uint32_t*>(Ph + r0 + 8 * L::LDH);
      const uint32_t* al0 = reinterpret_cast<const uint32_t*>(Pl + r0);
      const uint32_t* al1 =
          reinterpret_cast<const uint32_t*>(Pl + r0 + 8 * L::LDH);
      const float* qrow = Q + (nt[u] * 8 + g) * L::LDF + 2 * t;
#pragma unroll 2
      for (int ks = 0; ks <= mt[u]; ++ks) {
        const int kw = ks * 8;  // 32-bit words along k
        // In the diagonal k-step the upper 8 k's of the tile's first 8
        // rows lie beyond the diagonal: zeros that are never gathered.
        const bool diag = ks == mt[u];
        const uint32_t ah[4] = {ah0[kw], ah1[kw], diag ? 0u : ah0[kw + 4],
                                ah1[kw + 4]};
        const uint32_t al[4] = {al0[kw], al1[kw], diag ? 0u : al0[kw + 4],
                                al1[kw + 4]};
        const float2 f0 = *reinterpret_cast<const float2*>(qrow + ks * 16);
        const float2 f1 = *reinterpret_cast<const float2*>(qrow + ks * 16 + 8);
        uint32_t bh0, bl0, bh1, bl1;
        split_pair(f0.x, f0.y, bh0, bl0);
        split_pair(f1.x, f1.y, bh1, bl1);
        mma_bf16(acc[u], ah, bh0, bh1);
        mma_bf16(acc[u], ah, bl0, bl1);
        mma_bf16(acc[u], al, bh0, bh1);
      }
    }
  }
  if (sync) __syncthreads();
  if (active) {
#pragma unroll
    for (int u = 0; u < NTW; ++u) {
      const int p = mt[u] * 16 + g, q = nt[u] * 8 + 2 * t;
      epi(p, q, acc[u][0]);
      epi(p, q + 1, acc[u][1]);
      epi(p + 8, q, acc[u][2]);
      epi(p + 8, q + 1, acc[u][3]);
    }
  }
}

// `full` is a replicated operand in the format of `split`.
template <int R, class Epi>
__device__ __forceinline__ void chain_prod(bool split, const char* full,
                                           const float* Q, bool sync,
                                           Epi epi) {
  if (split) {
    const __nv_bfloat16* Ph = reinterpret_cast<const __nv_bfloat16*>(full);
    prod_split<R>(Ph, Ph + R * ChainLayout<R>::LDH, Q, sync, epi);
  } else {
    prod_f32<R>(reinterpret_cast<const float*>(full), Q, sync, epi);
  }
}

// Write eight consecutive elements of one row of a replicated operand
// (offset `row`, `col` in elements; col a multiple of 8) into every CTA's
// copy at byte offset `off`, in the format of `split`.
template <int R>
__device__ __forceinline__ void gather_store8(cg::cluster_group& cluster,
                                              char* smem, int off, bool split,
                                              int row, int col,
                                              const float (&v)[8]) {
  using L = ChainLayout<R>;
  if (split) {
    uint4 hi, lo;
    split_pair(v[0], v[1], hi.x, lo.x);
    split_pair(v[2], v[3], hi.y, lo.y);
    split_pair(v[4], v[5], hi.z, lo.z);
    split_pair(v[6], v[7], hi.w, lo.w);
    char* dst = smem + off + (row * L::LDH + col) * 2;
    for (int p = 0; p < L::CS; ++p) {
      char* rp = cluster.map_shared_rank(dst, p);
      *reinterpret_cast<uint4*>(rp) = hi;
      *reinterpret_cast<uint4*>(rp + R * L::LDH * 2) = lo;
    }
  } else {
    const float4 a = make_float4(v[0], v[1], v[2], v[3]);
    const float4 b = make_float4(v[4], v[5], v[6], v[7]);
    char* dst = smem + off + (row * L::LDF + col) * 4;
    for (int p = 0; p < L::CS; ++p) {
      float4* rp = reinterpret_cast<float4*>(cluster.map_shared_rank(dst, p));
      rp[0] = a;
      rp[1] = b;
    }
  }
}

// The two halves of a cluster barrier (cluster.sync() is both at once):
// arrive publishes this thread's earlier writes, DSMEM included; wait
// returns once every thread of the cluster has arrived, and makes their
// writes visible.  A thread alternates them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes from global to shared memory, asynchronously (cp.async; both
// addresses 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}

// Wait until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy an R x R row-major matrix (leading dimension ld, rows 16-byte
// aligned) into shared memory [R][LDF] as one cp.async group of this
// thread's share.  The caller waits (cp_async_wait) and then syncs.
template <int R>
__device__ __forceinline__ void load_full_async(float* dst, const float* src,
                                                int ld) {
  constexpr int V = R / 4;  // 16-byte vectors a row
  for (int e = threadIdx.x; e < R * V; e += kChainThreads) {
    const int i = e / V, c = 4 * (e % V);
    cp_async16(dst + i * ChainLayout<R>::LDF + c, src + (size_t)i * ld + c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Upper estimate of ||M||_2: 1.05 x two power-iteration steps, computed
// scale-normalized (ns.py::_norm2_est) so that ||M|| >~ 3e8 cannot overflow
// the sum of squares.  M is [R][LDF] in shared memory; one warp sums one
// row.
template <int R>
__device__ float chain_norm2_est(const float* M, float* v0, float* v1,
                                 float* red) {
  using L = ChainLayout<R>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto elem = [&](int i, int j) { return M[i * L::LDF + j]; };
  float m = 0.f;
  for (int e = threadIdx.x; e < R * R; e += kChainThreads)
    m = nan_max(m, fabsf(elem(e / R, e % R)));
  m = blk_max(m, red);
  const float a = nan_max(m, FLT_MIN);
  const float inv = 1.0f / a;
  // pass 0: v0 = M 1; pass 1: v1 = M v0; pass 2: |M v1 / |v1||^2.
  float n1 = 0.f;
  for (int pass = 0; pass < 3; ++pass) {
    const float sc = pass == 2 ? 1.0f / (n1 + 1e-30f) : 1.0f;
    float q = 0.f;
    for (int i = warp; i < R; i += kChainThreads / 32) {
      float s = 0.f;
      for (int j = lane; j < R; j += 32) {
        const float x = pass == 0 ? 1.0f : (pass == 1 ? v0[j] : v1[j] * sc);
        s = fmaf(elem(i, j) * inv, x, s);
      }
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) {
        if (pass == 0) v0[i] = s;
        if (pass == 1) v1[i] = s;
        q += s * s;
      }
    }
    const float tot = blk_sum(q, red);  // also the barrier between passes
    if (pass == 1) n1 = sqrtf(tot);
    if (pass == 2) return (1.05f * a) * sqrtf(tot);
  }
  return 0.f;  // not reached
}

// One whole chain (ns.py::_ns_kernel with _tri_ns) as one cluster of R / 16
// CTAs of kChainThreads threads:
//   G' = G + shift * ||G||_2-estimate * I   (when shift != 0)
//   X, E = tri_ns(G'): `iters` iterations of E = I - X^T W,
//          C = triu(E, 1) + diag(E) / 2, X <- X (I + om C); the first
//          `mid_iters` with bf16-split products; with fuse_xw all but the
//          final two carry W = G' X by W <- W (I + om C), the others
//          recompute it; `refine` seeds X = I and closes with the exact
//          residual E = I - X^T G' X.
//   t = X^T G'         written with leading dimension ldt, upper triangle
//                      only with triu_t (the robust passes keep the full
//                      product and truncate once, after combining them)
//   *resid = max|E| of the last E, reported per resid_mode.
template <int R>
__global__ void __launch_bounds__(kChainThreads, 1)
chain_kernel(const float* G, float* X, float* t, int ldt, float* resid,
             int iters, float shift, int refine, int mid_iters, int omega,
             int fuse_xw, int triu_t, int resid_mode) {
  using L = ChainLayout<R>;
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  // The 16 rows (of X, W, G') and columns (of T, E, C) that CTA p owns: the
  // p-th group of 8 from the top and the p-th from the bottom, so that every
  // CTA holds the same share of the triangular X and C and the gathers,
  // which skip the zeros beyond the diagonal, load the network evenly.
  auto own_of = [](int p, int l) {
    return l < 8 ? 8 * p + l : R - 8 * p - 16 + l;
  };
  auto own = [&](int l) { return own_of(rank, l); };

  float* Xs = reinterpret_cast<float*>(smem + L::OFF_XS);
  float* Ws = reinterpret_cast<float*>(smem + L::OFF_WS);
  float* Gs = reinterpret_cast<float*>(smem + L::OFF_GS);
  float* Qc = reinterpret_cast<float*>(smem + L::OFF_QC);
  float* dv = reinterpret_cast<float*>(smem + L::OFF_VEC);
  float* v0 = dv + R;
  float* v1 = v0 + R;
  float* red = v1 + R;
  float* cred = red + 32;

  // Setup, redundantly in every CTA, on a copy of G in the C^T buffer.
  float* Gf = reinterpret_cast<float*>(smem + L::OFF_C);
  for (int e = tid; e < R * R; e += kChainThreads)
    Gf[(e / R) * L::LDF + e % R] = G[e];
  __syncthreads();
  float sh = 0.f;
  if (shift != 0.f) {
    sh = shift * chain_norm2_est<R>(Gf, v0, v1, red);
    if (tid < R) Gf[tid * L::LDF + tid] += sh;
    __syncthreads();
  }
  if (refine) {
    if (tid < R) dv[tid] = 1.0f;
    __syncthreads();
  } else {
    // Jacobi scaling d = diag(G')^-1/2 and the spectral guard on D G' D
    // (held in the X^T buffer, which nothing uses yet).
    if (tid < R)
      dv[tid] = 1.0f / sqrtf(nan_max(Gf[tid * L::LDF + tid], FLT_MIN));
    __syncthreads();
    float* M0 = reinterpret_cast<float*>(smem + L::OFF_X);
    for (int e = tid; e < R * R; e += kChainThreads) {
      const int i = e / R, j = e % R;
      M0[i * L::LDF + j] = Gf[i * L::LDF + j] * dv[i] * dv[j];
    }
    __syncthreads();
    const float scale = 1.0f / sqrtf(chain_norm2_est<R>(M0, v0, v1, red));
    if (tid < R) dv[tid] *= scale;
    __syncthreads();
  }
  for (int e = tid; e < kStripe * R; e += kChainThreads) {
    const int li = e / R, j = e % R;
    const float g = Gf[own(li) * L::LDF + j];
    Gs[li * L::LDF + j] = g;
    Xs[li * L::LDF + j] = (own(li) == j) ? dv[j] : 0.f;
    Ws[li * L::LDF + j] = refine ? g : g * dv[j];
  }
  // Every CTA has started and is done with its copies of G and D G' D
  // before any remote store reaches it.
  cluster.sync();

  // All-gathers, one item of eight elements per thread (2 R items each).
  // X^T[i][k] and C^T[n][i] vanish for k > i and i > n: an item wholly
  // beyond the diagonal is not sent, and no product reads it.
  auto gather_X = [&](bool split) {  // X^T[i][own k] from own rows k of X
    if (tid < 2 * R) {
      const int i = tid % R, k0 = 8 * (tid / R);
      if (own(k0) > i) return;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = Xs[(k0 + e) * L::LDF + i];
      gather_store8<R>(cluster, smem, L::OFF_X, split, i, own(k0), v);
    }
  };
  auto gather_W = [&]() {  // CTA p gets W[own rows][p's columns] transposed
    if (tid < 2 * R) {
      const int p = tid >> 5, n = tid & 15, k0 = 8 * ((tid >> 4) & 1);
      const float* col = Ws + k0 * L::LDF + own_of(p, n);
      const float4 a = make_float4(col[0], col[L::LDF], col[2 * L::LDF],
                                   col[3 * L::LDF]);
      const float4 b = make_float4(col[4 * L::LDF], col[5 * L::LDF],
                                   col[6 * L::LDF], col[7 * L::LDF]);
      float4* rp = reinterpret_cast<float4*>(
          cluster.map_shared_rank(Qc + n * L::LDF + own(k0), p));
      rp[0] = a;
      rp[1] = b;
    }
  };
  auto gather_C = [&](bool split) {  // C^T[own n][i] from the staged stripe
    if (tid < 2 * R) {
      const int n = tid / (R / 8), i0 = 8 * (tid % (R / 8));
      if (i0 > own(n)) return;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = Qc[n * L::LDF + i0 + e];
      gather_store8<R>(cluster, smem, L::OFF_C, split, own(n), i0, v);
    }
  };
  // W = G' X on the own rows: D[p = n][q = i] = <X^T[n], G'[own i]>.
  auto fresh_W = [&](bool split) {
    chain_prod<R>(split, smem + L::OFF_X, Gs, false,
                  [&](int p, int q, float v) { Ws[q * L::LDF + p] = v; });
    __syncthreads();
    gather_W();
    cluster.sync();
  };
  // The own 16 columns of E = I - X^T W: D[p = i][q = n] = <X^T[i], W^T[n]>.
  // Keeps max|E| in `em`; with `stage`, leaves C^T's rows in Qc.
  float em = 1.0f;  // E = I before the first iteration
  auto correction = [&](bool split, bool stage) {
    em = 0.f;
    chain_prod<R>(split, smem + L::OFF_X, Qc, true,
                  [&](int p, int q, float v) {
                    const int j = own(q);
                    const float e = (p == j ? 1.f : 0.f) - v;
                    em = nan_max(em, fabsf(e));
                    if (stage)
                      Qc[q * L::LDF + p] =
                          j > p ? e : (j == p ? e * 0.5f : 0.f);
                  });
    __syncthreads();
  };

  const int n_om = (refine || !omega) ? 0 : min(4, max(0, iters - 4));
  const int n_fused = fuse_xw ? max(0, iters - 2) : 0;
  for (int it = 0; it < iters; ++it) {
    const float om = it < n_om ? 1.5f : 1.0f;
    const bool split = it < mid_iters;
    const bool fused = it < n_fused;
    gather_X(split);
    if (fused) gather_W();
    cluster.sync();
    if (!fused) fresh_W(split);
    correction(split, true);
    gather_C(split);
    cluster.sync();
    // X <- X + om X C on the own rows: D[p = n][q = i] = <C^T[n], X[i]>.
    chain_prod<R>(split, smem + L::OFF_C, Xs, true,
                  [&](int p, int q, float v) { Xs[q * L::LDF + p] += om * v; });
    if (fused)
      chain_prod<R>(split, smem + L::OFF_C, Ws, true,
                    [&](int p, int q, float v) {
                      Ws[q * L::LDF + p] += om * v;
                    });
    __syncthreads();
  }

  gather_X(false);
  cluster.sync();
  if (refine) {
    fresh_W(false);
    correction(false, false);
  }
  // X^{-1} = X^T G' at convergence: R recovered with no solve.  The own 16
  // columns: D[p = i][q = n] = <X^T[i], G'[:, own n]>.
  for (int e = tid; e < kStripe * R; e += kChainThreads) {
    const int k = e / kStripe, n = e % kStripe;
    Qc[n * L::LDF + k] = G[k * R + own(n)] + (k == own(n) ? sh : 0.f);
  }
  __syncthreads();
  prod_f32<R>(reinterpret_cast<const float*>(smem + L::OFF_X), Qc, false,
              [&](int p, int q, float v) {
                const int j = own(q);
                t[p * ldt + j] = (j >= p || !triu_t) ? v : 0.f;
              });
  for (int e = tid; e < kStripe * R; e += kChainThreads)
    X[own(e / R) * R + e % R] = Xs[(e / R) * L::LDF + e % R];

  // max|E| over the cluster, in rank order.
  em = blk_max(em, red);
  if (tid == 0) *cluster.map_shared_rank(cred + rank, 0) = em;
  cluster.sync();  // also: no CTA leaves while another may write into it
  if (rank == 0 && tid == 0) {
    float m = cred[0];
    for (int p = 1; p < L::CS; ++p) m = nan_max(m, cred[p]);
    if (resid_mode == RESID_SQUARE) m = m * m;
    else if (resid_mode == RESID_SCALE) m = m * 0.01f;
    *resid = m;
  }
}

// Launch `kern` as one thread-block cluster of `ctas` CTAs of kChainThreads
// threads, with `smem` bytes of dynamic shared memory, on `st`.  `fits` is
// a static of the caller's kernel instance: the first launch checks that
// the card can place one such cluster.
template <class... KArgs, class... Args>
static inline cudaError_t launch_cluster(void (*kern)(KArgs...), int ctas,
                                         int smem, cudaStream_t st,
                                         bool& fits, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(kChainThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!fits) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
    fits = true;
  }
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

template <int R>
static inline cudaError_t launch_chain_r(cudaStream_t st, const float* G,
                                         float* X, float* t, int ldt,
                                         float* resid, int iters, float shift,
                                         int refine, int mid_iters, int omega,
                                         int fuse_xw, int triu_t,
                                         int resid_mode) {
  using L = ChainLayout<R>;
  static bool fits = false;
  return launch_cluster(chain_kernel<R>, L::CS, L::BYTES, st, fits, G, X, t,
                        ldt, resid, iters, shift, refine, mid_iters, omega,
                        fuse_xw, triu_t, resid_mode);
}

// Launch the chain for a runtime r in {32, 64, 128} on `st`: G (r x r,
// fp32, row-major) -> X, t (leading dimension ldt) and *resid, all device
// pointers.  Returns the launch's error, or cudaErrorInvalidValue for
// another r.
static inline cudaError_t launch_chain(int r, cudaStream_t st, const float* G,
                                       float* X, float* t, int ldt,
                                       float* resid, int iters, float shift,
                                       int refine, int mid_iters, int omega,
                                       int fuse_xw, int triu_t,
                                       int resid_mode) {
#define MPBQR_CHAIN(RR)                                                     \
  return launch_chain_r<RR>(st, G, X, t, ldt, resid, iters, shift, refine,  \
                            mid_iters, omega, fuse_xw, triu_t, resid_mode)
  switch (r) {
    case 32: MPBQR_CHAIN(32);
    case 64: MPBQR_CHAIN(64);
    case 128: MPBQR_CHAIN(128);
    default: return cudaErrorInvalidValue;
  }
#undef MPBQR_CHAIN
}

}  // namespace mpbqr
