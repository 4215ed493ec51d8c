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
//     fused iteration, three per classic one).  Each warp starts its
//     stores at another CTA, so that no CTA takes the cluster's first
//     stores at once, and X is gathered as soon as it is updated, while
//     the W update runs.  Nothing goes through global scratch.  Measured
//     (utils/ns_probe.py --phases, H100): an exchange costs ~3.2-3.6k
//     cycles, a bare cluster barrier ~1.7k of them; arrival barriers
//     (mbarrier, a fence a thread and a remote arrive a CTA) in place of
//     the cluster barrier measured 6-10% slower a launch, so the cluster
//     barrier stays.
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
//     sum differs from the FMA form.  (Measured on the H100: neither three
//     accumulators a unit, a stripe split once a product into shared
//     memory, ldmatrix A fragments nor an unrolled k loop made it faster.)
//   * The fp32 products (Precision.HIGHEST: the two closing iterations,
//     refine chains, the exact residual and t = X^T G') stay true fp32 FMA,
//     never TF32 and never a bf16 split, as 16-byte shared-memory loads of
//     both operands along k into 4 x 4 register tiles, four k-classes a
//     tile pair added in a fixed tree (prod_f32).
//   * The Jacobi scaling, the spectral guard and the shift's norm estimate
//     are computed redundantly by every CTA from a copy of G loaded with
//     cp.async, each thread holding its share of the rows in registers for
//     the three passes (the same arithmetic in the same order, so all CTAs
//     agree bitwise and need no exchange).
// NaN survives every reduction (nan_max), across the cluster as well: the
// callers' poison canary depends on it.  Two launches on the same input give
// the same bits: no atomics, every reduction in a fixed order.
//
// The general (not triangular) fp32 product prod_gen, the cp.async loads
// of a whole replicated operand and the cluster launch below also run
// ninv_chain.cu (K4) and panel.cuh's combine.
//
// Widths.  The shared-memory route above is instantiated for R = 32, 64
// and 128 and takes any r <= R at run time: the chain runs on the
// smallest R >= r with every row and column beyond r zero.  Jacobi's d is
// 0 there (not diag^-1/2 of a zero pad), and the identities of E = I -
// X^T G X, of K4's E = 2I - S X and its residual stop at r, so X, W and E
// stay exactly zero beyond r, the norm estimates and every max see only
// the r x r problem, and only the r x r corner is read and written.  The
// pairing of rows p and R - 1 - p and the gathers' skipped zeros still run
// over R: they place work, not arithmetic.  A second instantiation (PAD)
// carries the run-time r; at r = R the first one runs, in which r is the
// constant R and every mask folds away, so nothing changes there.
// Beyond 128 the replicated operands (Xt and Ct: 2 x 4 r (r + 8) bytes a
// CTA, 540 KB at r = 256) no longer fit a CTA, so r > 128 takes the L2
// route at the end of this file.
#pragma once

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
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

// Batches.  A batched chain launch runs B chains of one width and one set
// of options: one cluster a member, the member blockIdx.y of a (cluster,
// B) grid.  Each pointer of member b lies b strides (floats) past member
// 0's; the kernel body only offsets its pointers, so every member gets
// the bits of a single launch on its operands.  One member: all zero.
struct ChainBatch {
  long long g, x, t, resid, scratch;
};

// Most members of one batched launch (the grid's y dimension).
constexpr int kMaxBatch = 65535;

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

// D[p][q] = sum_k P[p][k] Q[q][k] in true fp32 FMA.  P is [R][LDF], Q is
// [16][LDF], both in shared memory.  P is lower triangular (X^T and C^T
// are: P[p][k] == 0 for k > p), so row p sums the k-quads up to its own
// only.  What bounds it is the shared memory's wavefronts (a warp's
// 16-byte load costs four, whatever it broadcasts), so a thread keeps a
// 4-row x 4-q tile: 8 loads a k-quad for 64 FMA.  The tiles of row blocks
// rb and R / 4 - 1 - rb, together R / 4 + 1 k-quads, go to four threads
// that take every fourth k-quad of both (k-class s = tid % 4, ascending),
// so that every thread has the same work and needs no other thread's
// operands; the four partial sums of an element are then added over the
// lanes in one fixed tree, (s0 + s1) + (s2 + s3): the same bits every
// launch.  The 2 R threads this takes are all at R = 128; at 32 and 64 the
// others idle.  epi(p, q, value) runs once per element of D, after a block
// barrier when `sync` (for epilogues that overwrite an operand).
template <int R, class Epi>
__device__ __forceinline__ void prod_f32(const float* P, const float* Q,
                                         bool sync, Epi epi) {
  using L = ChainLayout<R>;
  constexpr int RB = R / 4;                // 4-row blocks of P
  constexpr int ACTIVE = 4 * (RB / 2) * 4;  // 4 k-classes x pairs x q blocks
  constexpr int P4 = L::LDF / 4;           // float4s a row
  const int s = threadIdx.x & 3, tau = threadIdx.x >> 2;
  const int rbp = tau >> 2, qb = tau & 3;
  const int rb[2] = {rbp, RB - 1 - rbp};
  // Whole warps are active or idle (ACTIVE is a multiple of 32).
  const bool active = threadIdx.x < ACTIVE;
  float acc[2][4][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[u][i][j] = 0.f;
  if (active) {
    const float4* qp = reinterpret_cast<const float4*>(Q) + 4 * qb * P4;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float4* pp = reinterpret_cast<const float4*>(P) + 4 * rb[u] * P4;
#pragma unroll 2
      for (int k4 = s; k4 <= rb[u]; k4 += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = pp[i * P4 + k4];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = qp[j * P4 + k4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[u][i][j] = fmaf(a[i].x, b[j].x, acc[u][i][j]);
            acc[u][i][j] = fmaf(a[i].y, b[j].y, acc[u][i][j]);
            acc[u][i][j] = fmaf(a[i].z, b[j].z, acc[u][i][j]);
            acc[u][i][j] = fmaf(a[i].w, b[j].w, acc[u][i][j]);
          }
      }
    }
  }
  // The four k-classes' sums over the lanes s, s ^ 1, s ^ 2: lane s keeps
  // tile s & 1 after the first step and its rows 2 (s >> 1) .. + 1 after
  // the second.
  float half[16], fin[8];
  if (active) {
    const bool t1 = s & 1, r2 = s & 2;
#pragma unroll
    for (int v = 0; v < 16; ++v) {
      const float mine = t1 ? acc[1][v >> 2][v & 3] : acc[0][v >> 2][v & 3];
      const float other = t1 ? acc[0][v >> 2][v & 3] : acc[1][v >> 2][v & 3];
      half[v] = mine + __shfl_xor_sync(0xffffffffu, other, 1);
    }
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const float mine = r2 ? half[8 + v] : half[v];
      const float other = r2 ? half[v] : half[8 + v];
      fin[v] = mine + __shfl_xor_sync(0xffffffffu, other, 2);
    }
  }
  if (sync) __syncthreads();
  if (active) {
    const int p0 = 4 * ((s & 1) ? rb[1] : rb[0]) + ((s & 2) ? 2 : 0);
#pragma unroll
    for (int v = 0; v < 8; ++v) epi(p0 + (v >> 2), 4 * qb + (v & 3), fin[v]);
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
// copy at byte offset `off`, in the format of `split`.  A warp starts at
// the CTA `first` past its own (its warp index and CTA rank: every CTA
// then receives from every warp of the cluster in turn, and no CTA's
// network port takes the whole cluster's first stores at once).
template <int R>
__device__ __forceinline__ void gather_store8(cg::cluster_group& cluster,
                                              char* smem, int off, bool split,
                                              int row, int col,
                                              const float (&v)[8]) {
  using L = ChainLayout<R>;
  const int first = (int)(threadIdx.x >> 5) + (int)cluster.block_rank();
  if (split) {
    uint4 hi, lo;
    split_pair(v[0], v[1], hi.x, lo.x);
    split_pair(v[2], v[3], hi.y, lo.y);
    split_pair(v[4], v[5], hi.z, lo.z);
    split_pair(v[6], v[7], hi.w, lo.w);
    char* dst = smem + off + (row * L::LDH + col) * 2;
    for (int p = 0; p < L::CS; ++p) {
      char* rp = cluster.map_shared_rank(dst, (first + p) % L::CS);
      *reinterpret_cast<uint4*>(rp) = hi;
      *reinterpret_cast<uint4*>(rp + R * L::LDH * 2) = lo;
    }
  } else {
    const float4 a = make_float4(v[0], v[1], v[2], v[3]);
    const float4 b = make_float4(v[4], v[5], v[6], v[7]);
    char* dst = smem + off + (row * L::LDF + col) * 4;
    for (int p = 0; p < L::CS; ++p) {
      float4* rp = reinterpret_cast<float4*>(
          cluster.map_shared_rank(dst, (first + p) % L::CS));
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

// Copy an n x n row-major matrix (leading dimension ld) into the leading
// corner of shared memory [R][LDF], zeros beyond n, as one cp.async group
// of this thread's share: 16-byte copies when n = R and the rows are
// 16-byte aligned, else plain loads (the group is then empty).  The caller
// waits (cp_async_wait) and then syncs.
template <int R>
__device__ __forceinline__ void load_full_async(float* dst, const float* src,
                                                int n, int ld) {
  if (n == R && ld % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    constexpr int V = R / 4;  // 16-byte vectors a row
    for (int e = threadIdx.x; e < R * V; e += kChainThreads) {
      const int i = e / V, c = 4 * (e % V);
      cp_async16(dst + i * ChainLayout<R>::LDF + c,
                 src + (size_t)i * ld + c);
    }
  } else {
    for (int e = threadIdx.x; e < R * R; e += kChainThreads) {
      const int i = e / R, j = e % R;
      dst[i * ChainLayout<R>::LDF + j] =
          (i < n && j < n) ? src[(size_t)i * ld + j] : 0.f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The shared-memory route's setup holds an R x R matrix spread over the
// block by rows: row i = tid / TPR, this thread's PER consecutive columns
// from j0 = (tid % TPR) PER, in registers.
template <int R>
struct RowShare {
  static constexpr int TPR = kChainThreads / R;  // threads a row
  static constexpr int PER = R / TPR;            // elements a thread
};

// Upper estimate of ||M||_2 (ns.py::_norm2_est: 1.05 x two power-iteration
// steps, scale-normalized so that ||M|| >~ 3e8 cannot overflow the sum of
// squares) of a matrix held by rows (RowShare), zeros beyond the problem:
// three passes, each from the registers, a row's sum taken by its TPR
// threads in a fixed xor tree (every one of them gets the same bits).  v0,
// v1 hold R floats.
template <int R>
__device__ float row_norm2_est(const float (&e)[RowShare<R>::PER], float* v0,
                               float* v1, float* red) {
  constexpr int TPR = RowShare<R>::TPR, PER = RowShare<R>::PER;
  const int i = threadIdx.x / TPR, j0 = (threadIdx.x % TPR) * PER;
  const bool lead = threadIdx.x % TPR == 0;
  float m = 0.f;
#pragma unroll
  for (int c = 0; c < PER; ++c) m = nan_max(m, fabsf(e[c]));
  m = blk_max(m, red);
  const float a = nan_max(m, FLT_MIN);
  const float inv = 1.0f / a;
  float n1 = 0.f;
  for (int pass = 0; pass < 3; ++pass) {
    const float sc = pass == 2 ? 1.0f / (n1 + 1e-30f) : 1.0f;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < PER; ++c) {
      const float x = pass == 0 ? 1.0f
                                : (pass == 1 ? v0[j0 + c] : v1[j0 + c] * sc);
      s = fmaf(e[c] * inv, x, s);
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lead && pass == 0) v0[i] = s;
    if (lead && pass == 1) v1[i] = s;
    const float tot = blk_sum(lead ? s * s : 0.f, red);  // also the barrier
    if (pass == 1) n1 = sqrtf(tot);
    if (pass == 2) return (1.05f * a) * sqrtf(tot);
  }
  return 0.f;  // not reached
}

// Per-CTA clock64 sums of a shared-memory-route launch's phases, compiled
// in only with -DMPBQR_NS_PROF; read by utils/ns_probe.py --phases, which
// names the slots (NSP_*, as CTA thread 0 sees them): the setup (G's load,
// the shift's norm estimate, Jacobi and the guard's norm estimate, the own
// stripes), the stores of the X, W and C all-gathers, the wait at the
// cluster barriers, the fresh W = G' X product of the unfused iterations,
// the correction product, the X and W update products, the closing
// t = X^T G' product with the stores of t and X, and the residual's
// cluster max (sent with the closing exchange, or after a refine chain's
// exact residual with a barrier of its own).  The global loads of G' for
// t, issued before the iterations, count with the first X gather.  Row 0
// of a CTA's record sums the whole launch, row 1 the iterations alone.  A
// batched launch writes them from member 0 only.
enum {
  NSP_SETUP, NSP_GATHER_X, NSP_GATHER_W, NSP_BARRIER, NSP_W_PRODUCT,
  NSP_CORRECTION, NSP_GATHER_C, NSP_UPDATE, NSP_CLOSE_T, NSP_CLUSTER_MAX,
  NSP_SLOTS
};
// The L2 route's clock (chain_l2_kernel) has slots of its own (NSL_*):
// the setup (norm estimates, Jacobi, seeding G', X and W), the fresh
// W = G' X product, the correction E = X^T W, the X and W updates, the
// wait at the cluster barriers with their __threadfence, the closing
// t = X^T G' product, the X store and the residual's cluster max; one
// record a CTA of the largest cluster (16), so that the CTAs' imbalance
// shows.
enum {
  NSL_SETUP, NSL_W_PRODUCT, NSL_CORRECTION, NSL_X_UPDATE, NSL_W_UPDATE,
  NSL_BARRIER, NSL_CLOSE_T, NSL_X_STORE, NSL_CLUSTER_MAX, NSL_SLOTS
};
#ifdef MPBQR_NS_PROF
static __device__ long long g_ns_prof[8][2][NSP_SLOTS];
static __device__ long long g_ns_l2_prof[16][2][NSL_SLOTS];
#define NS_PROF_INIT(N) constexpr int prof_n = N; long long pt = clock64(), pacc[N] = {}, ploop[N] = {};
#define NS_PROF(k) if (tid == 0) { const long long c = clock64(); pacc[k] += c - pt; pt = c; }
#define NS_PROF_LOOP(sign) if (tid == 0) for (int k = 0; k < prof_n; ++k) ploop[k] = pacc[k] - (sign) * ploop[k];
#define NS_PROF_SAVE(tab) if (tid == 0 && blockIdx.y == 0) for (int k = 0; k < prof_n; ++k) { tab[rank][0][k] = pacc[k]; tab[rank][1][k] = ploop[k]; }
#else
#define NS_PROF_INIT(N)
#define NS_PROF(k)
#define NS_PROF_LOOP(sign)
#define NS_PROF_SAVE(tab)
#endif

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
// G and X are nr x nr (leading dimension nr), t nr x nr, nr = R unless PAD
// (nr = n_arg <= R); member blockIdx.y's at the strides of `bt`.
template <int R, bool PAD>
__global__ void __launch_bounds__(kChainThreads, 1)
chain_kernel(const float* G, int n_arg, float* X, float* t, int ldt,
             float* resid, int iters, float shift, int refine, int mid_iters,
             int omega, int fuse_xw, int triu_t, int resid_mode,
             ChainBatch bt) {
  using L = ChainLayout<R>;
  const int nr = PAD ? n_arg : R;
  const int tid = threadIdx.x;
  NS_PROF_INIT(NSP_SLOTS)
  {
    const long long b = blockIdx.y;
    G += b * bt.g;
    X += b * bt.x;
    t += b * bt.t;
    resid += b * bt.resid;
  }
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
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

  // Setup, redundantly in every CTA, on a copy of G in the C^T buffer
  // (cp.async; zeros beyond nr) and, for the norm estimates, on this
  // thread's share of it by rows (RowShare) in registers.
  float* Gf = reinterpret_cast<float*>(smem + L::OFF_C);
  load_full_async<R>(Gf, G, nr, nr);
  cp_async_wait<0>();
  __syncthreads();
  constexpr int PER = RowShare<R>::PER;
  const int ri = tid / RowShare<R>::TPR, rj = (tid % RowShare<R>::TPR) * PER;
  float ge[PER];
#pragma unroll
  for (int c = 0; c < PER; c += 4) {
    const float4 g4 =
        *reinterpret_cast<const float4*>(Gf + ri * L::LDF + rj + c);
    ge[c] = g4.x;
    ge[c + 1] = g4.y;
    ge[c + 2] = g4.z;
    ge[c + 3] = g4.w;
  }
  float sh = 0.f;
  if (shift != 0.f) {
    sh = shift * row_norm2_est<R>(ge, v0, v1, red);
    if (tid < nr) Gf[tid * L::LDF + tid] += sh;
#pragma unroll
    for (int c = 0; c < PER; ++c)
      if (rj + c == ri && ri < nr) ge[c] += sh;
    __syncthreads();
  }
  if (refine) {
    if (tid < R) dv[tid] = tid < nr ? 1.0f : 0.f;
    __syncthreads();
  } else {
    // Jacobi scaling d = diag(G')^-1/2 (0 beyond nr) and the spectral guard
    // on D G' D, formed in the registers.
    if (tid < R)
      dv[tid] = tid < nr
                    ? 1.0f / sqrtf(nan_max(Gf[tid * L::LDF + tid], FLT_MIN))
                    : 0.f;
    __syncthreads();
#pragma unroll
    for (int c = 0; c < PER; ++c) ge[c] = ge[c] * dv[ri] * dv[rj + c];
    const float scale = 1.0f / sqrtf(row_norm2_est<R>(ge, v0, v1, red));
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
  NS_PROF(NSP_SETUP)
  // Every CTA has started and is done with its copy of G before any
  // remote store reaches it.
  cluster.sync();
  NS_PROF(NSP_BARRIER)

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
    NS_PROF(NSP_W_PRODUCT)
    gather_W();
    NS_PROF(NSP_GATHER_W)
    cluster.sync();
    NS_PROF(NSP_BARRIER)
  };
  // The own 16 columns of E = I - X^T W: D[p = i][q = n] = <X^T[i], W^T[n]>.
  // Keeps max|E| in `em`; with `stage`, leaves C^T's rows in Qc.
  float em = 1.0f;  // E = I before the first iteration
  auto correction = [&](bool split, bool stage) {
    em = 0.f;
    chain_prod<R>(split, smem + L::OFF_X, Qc, true,
                  [&](int p, int q, float v) {
                    const int j = own(q);
                    const float e = (p == j && p < nr ? 1.f : 0.f) - v;
                    em = nan_max(em, fabsf(e));
                    if (stage)
                      Qc[q * L::LDF + p] =
                          j > p ? e : (j == p ? e * 0.5f : 0.f);
                  });
    __syncthreads();
    NS_PROF(NSP_CORRECTION)
  };

  // G' = G + sh I on the own columns, for the closing t: loaded now, so
  // that the global loads' latency passes during the iterations.
  constexpr int TQ = kStripe * R / kChainThreads;
  float gq[TQ];
#pragma unroll
  for (int u = 0; u < TQ; ++u) {
    const int e = tid + kChainThreads * u;
    const int k = e / kStripe, j = own(e % kStripe);
    gq[u] = (k < nr && j < nr) ? G[k * nr + j] + (k == j ? sh : 0.f) : 0.f;
  }

  // Each iteration's X is gathered as soon as it is updated, and its W
  // update runs while those stores cross the network: the gather of the
  // next iteration's X (or the closing one's, in fp32) is issued between
  // the X and the W update.
  const int n_om = (refine || !omega) ? 0 : min(4, max(0, iters - 4));
  const int n_fused = fuse_xw ? max(0, iters - 2) : 0;
  gather_X(0 < mid_iters);
  NS_PROF(NSP_GATHER_X)
  NS_PROF_LOOP(0)
  for (int it = 0; it < iters; ++it) {
    const float om = it < n_om ? 1.5f : 1.0f;
    const bool split = it < mid_iters;
    const bool fused = it < n_fused;
    if (fused) gather_W();
    NS_PROF(NSP_GATHER_W)
    cluster.sync();
    NS_PROF(NSP_BARRIER)
    if (!fused) fresh_W(split);
    correction(split, true);
    gather_C(split);
    NS_PROF(NSP_GATHER_C)
    cluster.sync();
    NS_PROF(NSP_BARRIER)
    // X <- X + om X C on the own rows: D[p = n][q = i] = <C^T[n], X[i]>.
    chain_prod<R>(split, smem + L::OFF_C, Xs, true,
                  [&](int p, int q, float v) { Xs[q * L::LDF + p] += om * v; });
    __syncthreads();
    NS_PROF(NSP_UPDATE)
    gather_X(it + 1 < mid_iters);
    NS_PROF(NSP_GATHER_X)
    if (fused)
      chain_prod<R>(split, smem + L::OFF_C, Ws, true,
                    [&](int p, int q, float v) {
                      Ws[q * L::LDF + p] += om * v;
                    });
    __syncthreads();
    NS_PROF(NSP_UPDATE)
  }
  NS_PROF_LOOP(1)
  // max|E| over the cluster, in rank order, into rank 0's cred: without
  // refine the last E is known here, and its max joins the closing
  // exchange, so that no cluster barrier is left after it.
  auto send_max = [&]() {
    em = blk_max(em, red);
    if (tid == 0) *cluster.map_shared_rank(cred + rank, 0) = em;
  };
  if (!refine) send_max();
  NS_PROF(NSP_CLUSTER_MAX)
  cluster.sync();
  NS_PROF(NSP_BARRIER)
  if (refine) {
    fresh_W(false);
    correction(false, false);
  }
  // X^{-1} = X^T G' at convergence: R recovered with no solve.  The own 16
  // columns: D[p = i][q = n] = <X^T[i], G'[:, own n]>.
#pragma unroll
  for (int u = 0; u < TQ; ++u) {
    const int e = tid + kChainThreads * u;
    Qc[(e % kStripe) * L::LDF + e / kStripe] = gq[u];
  }
  __syncthreads();
  prod_f32<R>(reinterpret_cast<const float*>(smem + L::OFF_X), Qc, false,
              [&](int p, int q, float v) {
                const int j = own(q);
                if (p < nr && j < nr)
                  t[p * ldt + j] = (j >= p || !triu_t) ? v : 0.f;
              });
  for (int e = tid; e < kStripe * R; e += kChainThreads) {
    const int i = own(e / R), j = e % R;
    if (i < nr && j < nr) X[i * nr + j] = Xs[(e / R) * L::LDF + j];
  }
  NS_PROF(NSP_CLOSE_T)

  if (refine) {
    send_max();
    cluster.sync();  // also: no CTA leaves while another may write into it
  }
  if (rank == 0 && tid == 0) {
    float m = cred[0];
    for (int p = 1; p < L::CS; ++p) m = nan_max(m, cred[p]);
    if (resid_mode == RESID_SQUARE) m = m * m;
    else if (resid_mode == RESID_SCALE) m = m * 0.01f;
    *resid = m;
  }
  NS_PROF(NSP_CLUSTER_MAX)
  NS_PROF_SAVE(g_ns_prof)
}

// The launch configuration of `batch` thread-block clusters of `ctas` CTAs
// of kChainThreads threads (grid (ctas, batch), clusters (ctas, 1, 1)),
// with `smem` bytes of dynamic shared memory, on `st`; `attr` holds its
// one attribute.  Sets the kernel's shared-memory and cluster-size
// attributes (clusters above the portable 8 CTAs are allowed).
template <class... KArgs>
static inline cudaError_t cluster_config(void (*kern)(KArgs...), int ctas,
                                         int batch, int smem, cudaStream_t st,
                                         cudaLaunchConfig_t* cfg,
                                         cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (ctas > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(ctas, batch, 1);
  cfg->blockDim = dim3(kChainThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// Launch `kern` as `batch` thread-block clusters (cluster_config) on `st`.
// `fits` is a static of the caller's kernel instance (and cluster size):
// the first launch checks that the card can place one such cluster.
template <class... KArgs, class... Args>
static inline cudaError_t launch_cluster_batch(void (*kern)(KArgs...),
                                               int ctas, int batch, int smem,
                                               cudaStream_t st, bool& fits,
                                               Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster_config(kern, ctas, batch, smem, st, &cfg, attr);
  if (err != cudaSuccess) return err;
  if (!fits) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
    fits = true;
  }
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

// One cluster of launch_cluster_batch.
template <class... KArgs, class... Args>
static inline cudaError_t launch_cluster(void (*kern)(KArgs...), int ctas,
                                         int smem, cudaStream_t st,
                                         bool& fits, Args... args) {
  return launch_cluster_batch(kern, ctas, 1, smem, st, fits, args...);
}

// How many clusters of `kern` on `ctas` CTAs with `smem` bytes the card
// keeps resident at once, in *out (cudaOccupancyMaxActiveClusters): a
// batch of B runs in ceil(B / *out) waves.
template <class... KArgs>
static inline cudaError_t cluster_resident(void (*kern)(KArgs...), int ctas,
                                           int smem, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  *out = 0;
  cudaError_t err = cluster_config(kern, ctas, 1, smem, nullptr, &cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(out, kern, &cfg);
}

// -- the L2 route (r > 128) -------------------------------------------------
//
// What changes beyond 128: the replicated operands no longer fit a CTA, so
// every r x r operand lives whole in a global scratch, 4 r^2 bytes each
// (256 KB at r = 256), which stays in the 50 MB L2 (each product reads it
// by the copy engine, never through a stale L1 line).  One
// thread-block cluster of up to 16 CTAs (ops/kernels/ns.py::ns_layout:
// ceil(r / 16), capped by the card's largest cluster) runs a chain, and
// every product has the form
//     D[:, own] = op(A) B[:, own]
// with A whole and B the CTA's own columns, so a CTA writes only its own
// columns and reads the others' only as A.  The operands that change are
// double-buffered, so one cluster barrier an iteration separates the
// products that read them whole from the ones that write them (a
// __threadfence() before each barrier makes the global writes visible
// across the cluster).  Reading remote stripes over DSMEM instead was the
// other choice: it would hold X and W in shared memory only up to r = 512
// at 16 CTAs and still need the whole operand streamed through every CTA,
// so the L2 scratch, with no upper limit but the vectors, was taken.
//
// Every L2-route kernel runs its products through l2_tprod (below
// chain_l2_scratch_floats): K1's chain, K4 (ninv_chain.cu) and the R-block
// combine (panel.cuh), each with a scratch of its own matrices, described
// to the copy engine by l2_maps.
constexpr int kMaxWidth = 1024;      // ns.py::MAX_WIDTH
constexpr int kL2MaxCluster = 16;    // ns.py::L2_MAX_CLUSTER
enum { L2_A_LOWER = 1, L2_A_UPPER = 2, L2_B_UPPER = 4 };

// Leading dimension of an n x n operand in the L2 scratch: rows padded to
// 16 bytes.
__host__ __device__ __forceinline__ int l2_ld(int n) {
  return (n + 3) / 4 * 4;
}

// Publish this CTA's global writes to the cluster and wait for everyone's.
__device__ __forceinline__ void l2_barrier(cg::cluster_group& cluster) {
  __threadfence();
  cluster.sync();
}

// max over the cluster of every CTA's `m`, in rank order, into *out by
// rank 0 (after resid_mode); `red` and `cred` hold 32 floats each.
__device__ __forceinline__ void l2_cluster_max(cg::cluster_group& cluster,
                                               float m, float* red,
                                               float* cred, int resid_mode,
                                               float* out) {
  const int rank = (int)cluster.block_rank(), cs = (int)gridDim.x;
  m = blk_max(m, red);
  if (threadIdx.x == 0) *cluster.map_shared_rank(cred + rank, 0) = m;
  cluster.sync();  // also: no CTA leaves while another may write into it
  if (rank == 0 && threadIdx.x == 0) {
    float v = cred[0];
    for (int p = 1; p < cs; ++p) v = nan_max(v, cred[p]);
    if (resid_mode == RESID_SQUARE) v = v * v;
    else if (resid_mode == RESID_SCALE) v = v * 0.01f;
    *out = v;
  }
}

// -- K1's chain on the L2 route ------------------------------------------
//
// What its clock showed (utils/ns_probe.py --phases, H100, r = 256
// chain_mid, on the route's first products): the setup took 16% of a
// launch (both norm
// estimates in every CTA, scalar loads); the products of the triangular X
// and C ran 3-7x longer on the last CTA than on the first, whose barrier
// waits made up the difference; a 32-deep stage of 128 rows took ~3k
// cycles, fp32 or split alike.  The design:
//   * Columns are dealt in tiles of kL2Tile = 8 like a snake: tile j * cs
//     + p (even rounds j) or j * cs + cs - 1 - p (odd ones) to CTA p of a
//     cluster of cs, so that the first and the last columns, which end the
//     triangles soonest and latest, go to the same CTA: at r = 256 CTA p
//     owns tiles p and 31 - p, and every CTA has about the same work.  A
//     product takes a CTA's tiles two at a time (a unit of 16 columns) and
//     the rows in blocks of kL2URows = 256; each warp takes one tile and
//     64 rows and skips the stages that lie wholly in the zero triangles
//     its rows and columns see, so the warps of the early tile idle once
//     their triangle ends.  Inside a stage a warp multiplies every k
//     (exact zeros past its triangles): no branch between the k-steps.
//   * Every A is read k-major (A[k][i]: D = A^T B): the scratch keeps X^T
//     and W^T beside X and W (written by the same epilogues) and G'^T
//     beside G', so that no tile is transposed on its way in.  A stage,
//     kL2UDepth = 64 k-rows of A (256 rows, in boxes of 32, the 128-byte
//     swizzle) and of B (the unit's two tiles), arrives by the copy engine
//     (TMA: one tensor map over the launch's whole scratch, rows past r
//     zero-filled) on the stage's `full` mbarrier, into a ring of
//     kL2Stages buffers two stages ahead of the one multiplied; one
//     thread starts it once every warp has arrived on the slot's `empty`
//     mbarrier, and no block barrier runs a stage.
//   * fp32 (Precision.HIGHEST: the closing iterations, refine chains, t):
//     a thread keeps a 4-row x 4-column register tile, 8 16-byte loads a
//     k-quad for 64 FMA (the first products: 3 for 8), k ascending.
//   * split (chain_mid): a warp keeps four m16n8 tiles (64 rows x its 8
//     columns); both operands' fragments are loaded from the fp32 stages
//     and split into bf16 hi / lo in registers (a pair by one conversion),
//     hi*hi + hi*lo + lo*hi in three mma.sync m16n8k16 into one fp32
//     accumulator, each pass over the four tiles in turn.
//   * The norm estimates of the setup are split over the cluster: each CTA
//     takes a stripe of rows for every pass, and the vectors and partial
//     sums are exchanged through distributed shared memory, a cluster
//     barrier a pass; every CTA adds the partial sums in rank order, so all
//     of them hold the same bits.
// Measured on the way (A / B builds of this file in one call each, H100,
// PERF.md §6): per-thread cp.async in place of TMA moved the same bytes with
// 2304 requests a stage through the queue that the products' shared-memory
// loads use, and loads and products then barely overlapped (0.340 ms
// `chain_mid` at r = 256; without products 0.218, without loads 0.261,
// without either 0.110); bulk copies of 64-row pieces, a deeper ring and
// a stage order rotated by rank were no faster.
// Every element still has one fixed summation order: two launches give the
// same bits.

// The L2 chain's scratch: n x l2_ld(n) floats each of G' and G'^T; X,
// X^T, W and W^T twice; C, in this order (the third coordinate of its
// tensor maps).
enum {
  L2M_GP = 0, L2M_GPT = 1, L2M_X = 2, L2M_XT = 4, L2M_W = 6, L2M_WT = 8,
  L2M_C = 10, kL2Mats = 11
};
__host__ __device__ __forceinline__ long long chain_l2_scratch_floats(int n) {
  return (long long)kL2Mats * n * l2_ld(n);
}

constexpr int kL2Tile = 8;       // columns of a dealt tile
constexpr int kL2URows = 256;    // rows of a product block (a warp: 64)
constexpr int kL2UDepth = 64;    // k per stage of the chain's products
constexpr int kL2Box = 32;       // A arrives in boxes of 64 k x 32 rows
constexpr int kL2BoxFloats = kL2UDepth * kL2Box;
constexpr int kL2Stages = 3;     // the ring of stages
// A stage: A's eight boxes, then B's two tiles [64 k][8 columns].
constexpr int kL2UStageFloats =
    (kL2URows / kL2Box) * kL2BoxFloats + 2 * kL2UDepth * kL2Tile;
// The ring (ns.py::L2_CHAIN_STAGE_FLOATS), and the floats before it
// (ns.py::L2_RING_SLACK_FLOATS): its mbarriers, and room to start it on
// a 1024-byte boundary, as the 128-byte swizzle of A's boxes needs.
constexpr int kL2RingFloats = kL2Stages * kL2UStageFloats;
constexpr int kL2RingSlack = 512;
static_assert(kL2UStageFloats % 256 == 0, "every stage 1024-byte aligned");

// Tile of CTA `rank`'s slot j in a cluster of cs (the snake).
__device__ __forceinline__ int l2_tile(int rank, int cs, int j) {
  return j * cs + ((j & 1) ? cs - 1 - rank : rank);
}

// Slots a CTA holds for an n-wide chain on cs CTAs.
__device__ __forceinline__ int l2_slots(int n, int cs) {
  const int tiles = (n + kL2Tile - 1) / kL2Tile;
  return (tiles + cs - 1) / cs;
}

// The L2 operands by the copy engine.  The launch describes the scratch
// of all its members as one 3-D tensor (l2_maps): columns (ld, the rows
// padded to 16 bytes), rows (n: rows past n arrive as zeros) and matrices
// (the kernel's own count a member: kL2Mats for K1's chain).  A box lands
// on the stage's mbarrier.
__device__ __forceinline__ uint32_t l2_smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void l2_mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void l2_mbar_arrive_tx(uint32_t bar,
                                                  uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void l2_mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// This thread's global writes, ordered before the copy engine's later
// reads of them (after a barrier that the reader's issuing thread
// passes).
__device__ __forceinline__ void l2_fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
// Spin until the barrier's phase differs from `parity`.
__device__ __forceinline__ void l2_mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// The box at (column c, row k, matrix m) of `map` into shared memory.
__device__ __forceinline__ void l2_tma_load(float* dst, const CUtensorMap* map,
                                            uint32_t bar, int c, int k,
                                            int m) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(l2_smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(k), "r"(m)
      : "memory");
}

// split_pair's two-term bf16 split, the pair converted at once (the same
// bits).
__device__ __forceinline__ void split_pair2(float x, float y, uint32_t& hi,
                                            uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Element (k, r) of a stage's A, r < 256: box r / 32, row k of 128 bytes,
// its 16-byte pieces swizzled by k % 8 (CU_TENSOR_MAP_SWIZZLE_128B).
__device__ __forceinline__ int l2_a_at(int k, int r) {
  return (r >> 5) * kL2BoxFloats + k * kL2Box +
         ((((r & 31) >> 2) ^ (k & 7)) << 2) + (r & 3);
}

// The L2 ring: kL2Stages stages, each with a `full` mbarrier (its copies
// landed) and an `empty` one (every warp is done with it).
struct L2Ring {
  float* buf;
  uint32_t bars;
  int seq;  // stages the ring has taken, the same in every thread
  __device__ __forceinline__ uint32_t full(int slot) const {
    return bars + 8 * slot;
  }
  __device__ __forceinline__ uint32_t empty(int slot) const {
    return bars + 8 * (kL2Stages + slot);
  }
};

// D[i][c] = sum_k A[k][i] B[k][c] for every i < n and every column c of
// this CTA's tiles (rank of cs), A and B the matrices ma and mb of the
// member's scratch (`mats` their n x ld floats each, `maps` their tensor
// maps: A's boxes, B's tiles; `mat0` the member's first matrix);
// epi(i, c, value, old(i, c)) once per element, a thread's old values all
// loaded before its first epilogue (an update's old X or W: 16 L2 reads in
// flight at once, not one after another behind the stores).  `tri` (L2_*)
// names the zero triangles of A^T (LOWER: k > i, UPPER: k < i) and of B
// (k > c), whose k-steps are skipped.  Every thread of the block calls it
// (it syncs); the epilogue must not write A or B.  With TILE (fp32 only;
// `old` unused) the epilogue takes a thread's whole 4 x 4 tile at once,
// epi(i, c, acc) with rows i .. i + 3 and columns c .. c + 3, acc[4 row +
// column], rows and columns past n included (i < n and c < ld, both
// multiples of 4), so that it can store 16-byte pieces.
template <bool SPLIT, bool TILE = false, class Old, class Epi>
__device__ void l2_tprod(int n, int ma, int mb, const CUtensorMap* mapA,
                         const CUtensorMap* mapB, int mat0, int ld, int rank,
                         int cs, int tri, L2Ring& ring, Old old, Epi epi) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = warp >> 2, rb = warp & 3;  // the warp's tile and row block
  const int slots = l2_slots(n, cs);
  for (int u = 0; u < slots; u += 2) {
    int tc[2];  // the unit's two tiles' first columns (>= n: none)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      tc[q] = (u + q < slots) ? kL2Tile * l2_tile(rank, cs, u + q) : n;
    if (tc[0] >= n) continue;
    for (int i0 = 0; i0 < n; i0 += kL2URows) {
      // Each warp's k-range, and the block's (the union over its warps).
      auto range = [&](int hh, int rr, int& kb, int& ke) {
        const int row = i0 + 64 * rr;
        kb = (tri & L2_A_UPPER) ? row : 0;
        ke = n;
        if (tri & L2_A_LOWER) ke = min(ke, row + 64);
        if (tri & L2_B_UPPER) ke = min(ke, tc[hh] + kL2Tile);
        if (row >= n || tc[hh] >= n) ke = kb;  // nothing to do
      };
      int kb = n, ke = 0, wb[8], we[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        range(w >> 2, w & 3, wb[w], we[w]);
        if (wb[w] < we[w]) {
          kb = min(kb, wb[w]);
          ke = max(ke, we[w]);
        }
      }
      if (kb >= ke) continue;
      kb = kb / kL2UDepth * kL2UDepth;
      const int wkb = wb[warp], wke = we[warp];
      const int ns = (ke - kb + kL2UDepth - 1) / kL2UDepth;
      // One stage, by thread 0, once every warp is done with the stage
      // that last used its slot: A's boxes of 32 rows that a warp of
      // theirs multiplies in it (none past the padded rows), B's two
      // tiles.
      auto fetch = [&](int s) {
        const int g = ring.seq + s, slot = g % kL2Stages;
        if (g >= kL2Stages)
          l2_mbar_wait(ring.empty(slot), (g / kL2Stages - 1) & 1);
        float* sa = ring.buf + slot * kL2UStageFloats;
        float* sb = sa + (kL2URows / kL2Box) * kL2BoxFloats;
        const uint32_t bar = ring.full(slot);
        const int k0 = kb + s * kL2UDepth;
        bool need[8];
        uint32_t bytes = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int q = j >> 1;
          need[j] = i0 + kL2Box * j < ld &&
                    ((wb[q] < k0 + kL2UDepth && we[q] > k0) ||
                     (wb[4 + q] < k0 + kL2UDepth && we[4 + q] > k0));
          bytes += need[j] ? kL2BoxFloats * 4 : 0;
        }
        bytes += (tc[0] < n ? kL2UDepth * kL2Tile * 4 : 0) +
                 (tc[1] < n ? kL2UDepth * kL2Tile * 4 : 0);
        l2_mbar_arrive_tx(bar, bytes);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (need[j])
            l2_tma_load(sa + j * kL2BoxFloats, mapA, bar, i0 + kL2Box * j, k0,
                        mat0 + ma);
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (tc[q] < n)
            l2_tma_load(sb + q * kL2UDepth * kL2Tile, mapB, bar, tc[q], k0,
                        mat0 + mb);
      };
      // This thread's A offsets in a stage (l2_a_at), the same every
      // stage.  split: per m-tile, rows ra = 64 rb + 16 mt + g and ra + 8
      // at k = 2 t4 and 2 t4 + 1 (k % 8 is one of those two at every k of
      // its fragments); fp32: its box and row start, and its 16-byte piece
      // (the piece's swizzle by k % 8 is applied per k).
      int aoff[4][4];
      if constexpr (SPLIT) {
        const int t4 = lane & 3;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int ra = 64 * rb + 16 * mt + (lane >> 2);
          aoff[mt][0] = l2_a_at(2 * t4, ra);
          aoff[mt][1] = l2_a_at(2 * t4 + 1, ra);
          aoff[mt][2] = l2_a_at(2 * t4, ra + 8);
          aoff[mt][3] = l2_a_at(2 * t4 + 1, ra + 8);
        }
      } else {
        const int r0 = 64 * rb + 4 * (lane >> 1);
        aoff[0][0] = (r0 >> 5) * kL2BoxFloats;
        aoff[0][1] = (r0 & 31) >> 2;
      }
      float acc[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) acc[q] = 0.f;
      if (tid == 0)
        for (int s = 0; s < kL2Stages - 1 && s < ns; ++s) fetch(s);
      // No block barrier a stage: each warp waits for its stage's copies
      // and releases its slot (one arrival a warp).
      for (int s = 0; s < ns; ++s) {
        const int slot = (ring.seq + s) % kL2Stages;
        if (tid == 0 && s + kL2Stages - 1 < ns) fetch(s + kL2Stages - 1);
        l2_mbar_wait(ring.full(slot), ((ring.seq + s) / kL2Stages) & 1);
        const float* sa = ring.buf + slot * kL2UStageFloats;
        const float* sb = sa + (kL2URows / kL2Box) * kL2BoxFloats +
                          h * kL2UDepth * kL2Tile;
        const int k0 = kb + s * kL2UDepth;
        if (wkb < k0 + kL2UDepth && wke > k0) {
          // Inside a stage a warp multiplies every k of its rows and tile:
          // past its triangles both operands hold exact zeros (the epilogues
          // write them; the copy engine fills rows past n), so the k-steps
          // need no branch, and the loads of the next k-steps and the
          // products of this one overlap.
          if constexpr (SPLIT) {
            // m16n8k16 fragments (prod_split): A rows 16 mt + g (+8), k 2 t4
            // (+1) (+8); B column g of the warp's tile.  The three passes
            // hi*hi, hi*lo, lo*hi run over the four m-tiles in turn, each
            // accumulator in the same order as prod_split's.
            const int t4 = lane & 3;
#pragma unroll
            for (int ks = 0; ks < kL2UDepth; ks += 16) {
              const int kabs = k0 + ks;
              if (kabs < wkb || kabs >= wke) continue;
              const float* bp = sb + (ks + 2 * t4) * kL2Tile + (lane >> 2);
              uint32_t bh0, bl0, bh1, bl1;
              split_pair2(bp[0], bp[kL2Tile], bh0, bl0);
              split_pair2(bp[8 * kL2Tile], bp[9 * kL2Tile], bh1, bl1);
              const float* sk = sa + ks * kL2Box;
              constexpr int K8 = 8 * kL2Box;
              uint32_t ah[4][4], al[4][4];
#pragma unroll
              for (int mt = 0; mt < 4; ++mt) {
                const int* o = aoff[mt];
                split_pair2(sk[o[0]], sk[o[1]], ah[mt][0], al[mt][0]);
                split_pair2(sk[o[2]], sk[o[3]], ah[mt][1], al[mt][1]);
                split_pair2(sk[o[0] + K8], sk[o[1] + K8], ah[mt][2],
                            al[mt][2]);
                split_pair2(sk[o[2] + K8], sk[o[3] + K8], ah[mt][3],
                            al[mt][3]);
              }
#pragma unroll
              for (int mt = 0; mt < 4; ++mt)
                mma_bf16(*reinterpret_cast<float(*)[4]>(acc + 4 * mt), ah[mt],
                         bh0, bh1);
#pragma unroll
              for (int mt = 0; mt < 4; ++mt)
                mma_bf16(*reinterpret_cast<float(*)[4]>(acc + 4 * mt), ah[mt],
                         bl0, bl1);
#pragma unroll
              for (int mt = 0; mt < 4; ++mt)
                mma_bf16(*reinterpret_cast<float(*)[4]>(acc + 4 * mt), al[mt],
                         bh0, bh1);
            }
          } else {
            // A thread's 4 x 4 tile: rows r0 .. r0 + 3 (one 16-byte piece of
            // a box row), columns 4 (lane & 1) of the warp's tile.
            const float* bp = sb + 4 * (lane & 1);
#pragma unroll
            for (int kq = 0; kq < kL2UDepth; kq += 4) {
              float4 a[4], b[4];
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                a[kk] = *reinterpret_cast<const float4*>(sa + aoff[0][0] +
                                                         (kq + kk) * kL2Box +
                                                         (((kq + kk) & 7) ^
                                                          aoff[0][1]) * 4);
                b[kk] = *reinterpret_cast<const float4*>(
                    bp + (kq + kk) * kL2Tile);
              }
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                const float av[4] = {a[kk].x, a[kk].y, a[kk].z, a[kk].w};
                const float bv[4] = {b[kk].x, b[kk].y, b[kk].z, b[kk].w};
#pragma unroll
                for (int ii = 0; ii < 4; ++ii)
#pragma unroll
                  for (int cc = 0; cc < 4; ++cc)
                    acc[4 * ii + cc] =
                        fmaf(av[ii], bv[cc], acc[4 * ii + cc]);
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) l2_mbar_arrive(ring.empty(slot));
      }
      ring.seq += ns;
      if (tc[h] >= n) continue;
      if constexpr (TILE) {
        static_assert(!SPLIT, "a tile epilogue takes the fp32 tiles");
        const int i = i0 + 64 * rb + 4 * (lane >> 1);
        const int c = tc[h] + 4 * (lane & 1);
        if (i < n && c < ld) epi(i, c, acc);
      } else {
        // Element q of this thread: split, acc[4 mt + j] in m16n8's
        // layout; fp32, its 4 x 4 tile by rows.
        auto at = [&](int q, int& i, int& c) {
          if constexpr (SPLIT) {
            i = i0 + 64 * rb + 16 * (q >> 2) + (lane >> 2) +
                8 * ((q >> 1) & 1);
            c = tc[h] + 2 * (lane & 3) + (q & 1);
          } else {
            i = i0 + 64 * rb + 4 * (lane >> 1) + (q >> 2);
            c = tc[h] + 4 * (lane & 1) + (q & 3);
          }
        };
        float prev[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          int i, c;
          at(q, i, c);
          prev[q] = (i < n && c < n) ? old(i, c) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          int i, c;
          at(q, i, c);
          if (i < n && c < n) epi(i, c, acc[q], prev[q]);
        }
      }
    }
  }
  l2_fence_proxy_global();  // a later product may read these by TMA
}

// The ring's mbarriers, initialized once a launch before its first
// product (`empty` counts `warps` arrivals: one a warp of the block); the
// ring starts on the first 1024-byte boundary past them.
__device__ __forceinline__ L2Ring l2_ring_init(
    float* sm, uint32_t warps = kChainThreads / 32) {
  const uint32_t base = l2_smem_u32(sm);
  const uint32_t at = (base + 64 + 1023) & ~1023u;
  static_assert(16 * kL2Stages <= 64, "the barriers fit before the ring");
  if (threadIdx.x == 0) {
    for (int s = 0; s < kL2Stages; ++s) {
      l2_mbar_init(base + 8 * s, 1);                           // full
      l2_mbar_init(base + 8 * (kL2Stages + s), warps);  // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return L2Ring{sm + (at - base) / 4, base, 0};
}

template <class Old, class Epi>
__device__ __forceinline__ void l2_tprod_any(bool split, int n, int ma,
                                             int mb, const CUtensorMap* mapA,
                                             const CUtensorMap* mapB,
                                             int mat0, int ld, int rank,
                                             int cs, int tri, L2Ring& ring,
                                             Old old, Epi epi) {
  if (split)
    l2_tprod<true>(n, ma, mb, mapA, mapB, mat0, ld, rank, cs, tri, ring, old,
                   epi);
  else
    l2_tprod<false>(n, ma, mb, mapA, mapB, mat0, ld, rank, cs, tri, ring, old,
                    epi);
}

// The old value of a product whose epilogue reads none.
struct L2NoOld {
  __device__ __forceinline__ float operator()(int, int) const { return 0.f; }
};

// Every element (i, c) of this CTA's tiles' columns, i < n: f(i, c).
template <class F>
__device__ __forceinline__ void l2_own_each(int n, int rank, int cs, F f) {
  const int slots = l2_slots(n, cs);
#pragma unroll 4
  for (int e = threadIdx.x; e < slots * kL2Tile * n; e += kChainThreads) {
    const int j = e / (kL2Tile * n), rest = e % (kL2Tile * n);
    const int c = kL2Tile * l2_tile(rank, cs, j) + rest % kL2Tile;
    if (c < n) f(rest / kL2Tile, c);
  }
}

// The cluster's vectors and partial sums of l2_norm2_est, in every CTA's
// shared memory: v0, v1 (n each) and kNormSlots x kL2MaxCluster floats.
constexpr int kNormSlots = 3;

// The estimate of row_norm2_est (ns.py::_norm2_est) of the n x n matrix
// elem(i, j), split over the
// cluster: CTA `rank` of cs takes the rows [rank rw, (rank + 1) rw), one
// warp a row, and sends its entries of v0 and v1 and its partial maxima
// and sums to every CTA through distributed shared memory, a cluster
// barrier a pass; every CTA then reduces the partials in rank order and
// returns the same bits.  `part` holds kNormSlots x kL2MaxCluster floats;
// each slot is written once an estimate and read after the next barrier,
// so two estimates in a row need no barrier between them.  The cluster
// must have synced once before the first call (remote stores).
template <class Elem>
__device__ float l2_norm2_est(cg::cluster_group& cluster, int n, int rank,
                              int cs, Elem elem, float* v0, float* v1,
                              float* red, float* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = (n + cs - 1) / cs;
  const int r0 = min(n, rank * rw), r1 = min(n, r0 + rw);
  auto publish = [&](int slot, float v) {  // thread 0 of the block
    for (int p = 0; p < cs; ++p)
      *cluster.map_shared_rank(part + slot * kL2MaxCluster + rank, p) = v;
  };
  float m = 0.f;
  for (int e = threadIdx.x; e < (r1 - r0) * n; e += kChainThreads)
    m = nan_max(m, fabsf(elem(r0 + e / n, e % n)));
  m = blk_max(m, red);
  if (threadIdx.x == 0) publish(0, m);
  cluster.sync();
  float a = part[0];
  for (int p = 1; p < cs; ++p) a = nan_max(a, part[p]);
  a = nan_max(a, FLT_MIN);
  const float inv = 1.0f / a;
  // pass 0: v0 = M 1; pass 1: v1 = M v0; pass 2: |M v1 / |v1||^2.
  float n1 = 0.f;
  for (int pass = 0; pass < 3; ++pass) {
    const float sc = pass == 2 ? 1.0f / (n1 + 1e-30f) : 1.0f;
    float q = 0.f;
    for (int i = r0 + warp; i < r1; i += kChainThreads / 32) {
      float s = 0.f;
#pragma unroll 4
      for (int j = lane; j < n; j += 32) {
        const float x = pass == 0 ? 1.0f : (pass == 1 ? v0[j] : v1[j] * sc);
        s = fmaf(elem(i, j) * inv, x, s);
      }
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (pass < 2 && lane < cs)
        *cluster.map_shared_rank((pass == 0 ? v0 : v1) + i, lane) = s;
      if (lane == 0) q += s * s;
    }
    if (pass == 0) {
      cluster.sync();
      continue;
    }
    const float tot = blk_sum(q, red);
    if (threadIdx.x == 0) publish(pass, tot);
    cluster.sync();
    float sum = 0.f;
    for (int p = 0; p < cs; ++p) sum += part[pass * kL2MaxCluster + p];
    if (pass == 1) n1 = sqrtf(sum);
    if (pass == 2) return (1.05f * a) * sqrtf(sum);
  }
  return 0.f;  // not reached
}

// The chain of chain_kernel on the L2 route: the same arithmetic, steps
// and options, for any n <= kMaxWidth, as one cluster of the launch's
// CTAs.  G (n x n, leading dimension n) -> X (n x n), t (ldt), *resid;
// member blockIdx.y's, and its own scratch, at the strides of `bt`.
// mapA / mapB describe the launch's scratch (l2_maps).  Dynamic shared
// memory: kL2RingSlack + kL2RingFloats + 3 n + 64 + kNormSlots x
// kL2MaxCluster floats.
static __global__ void __launch_bounds__(kChainThreads, 1)
chain_l2_kernel(const float* G, int n, float* X, float* t, int ldt,
                float* resid, int iters, float shift, int refine,
                int mid_iters, int omega, int fuse_xw, int triu_t,
                int resid_mode, float* scratch, ChainBatch bt,
                const __grid_constant__ CUtensorMap mapA,
                const __grid_constant__ CUtensorMap mapB) {
  const int tid = threadIdx.x;
  NS_PROF_INIT(NSL_SLOTS)
  {
    const long long b = blockIdx.y;
    G += b * bt.g;
    X += b * bt.x;
    t += b * bt.t;
    resid += b * bt.resid;
    scratch += b * bt.scratch;
  }
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cs = (int)gridDim.x;
  const int ld = l2_ld(n);
  const size_t mat = (size_t)n * ld;
  float* Gp = scratch + L2M_GP * mat;
  float* GpT = scratch + L2M_GPT * mat;
  float* Xb[2] = {scratch + L2M_X * mat, scratch + (L2M_X + 1) * mat};
  float* XTb[2] = {scratch + L2M_XT * mat, scratch + (L2M_XT + 1) * mat};
  float* Wb[2] = {scratch + L2M_W * mat, scratch + (L2M_W + 1) * mat};
  float* WTb[2] = {scratch + L2M_WT * mat, scratch + (L2M_WT + 1) * mat};
  float* Cb = scratch + L2M_C * mat;
  const int mat0 = kL2Mats * (int)blockIdx.y;  // the member's first matrix
  const CUtensorMap* mA = &mapA;
  const CUtensorMap* mB = &mapB;
  L2Ring ring = l2_ring_init(sm);
  float* dv = sm + kL2RingSlack + kL2RingFloats;
  float* v0 = dv + n;
  float* v1 = v0 + n;
  float* red = v1 + n;
  float* cred = red + 32;
  float* part = cred + 32;

  // Setup: the norm estimates split over the cluster (l2_norm2_est), the
  // Jacobi scaling in every CTA (n diagonal loads), the own columns of G',
  // G'^T, X, X^T, W and W^T seeded.
  if (shift != 0.f || !refine) cluster.sync();  // before any remote store
  float sh = 0.f;
  if (shift != 0.f)
    sh = shift * l2_norm2_est(
                     cluster, n, rank, cs,
                     [&](int i, int j) { return __ldg(G + (size_t)i * n + j); },
                     v0, v1, red, part);
  // G is read-only here: its loads may run ahead of the stores below.
  auto gs = [&](int i, int j) {  // G' = G + sh I
    const float g = __ldg(G + (size_t)i * n + j);
    return (i == j && shift != 0.f) ? g + sh : g;
  };
  for (int i = tid; i < n; i += kChainThreads)
    dv[i] = refine ? 1.0f : 1.0f / sqrtf(nan_max(gs(i, i), FLT_MIN));
  __syncthreads();
  if (!refine) {
    const float scale = 1.0f / sqrtf(l2_norm2_est(
                                   cluster, n, rank, cs,
                                   [&](int i, int j) {
                                     return gs(i, j) * dv[i] * dv[j];
                                   },
                                   v0, v1, red, part));
    for (int i = tid; i < n; i += kChainThreads) dv[i] *= scale;
    __syncthreads();
  }
  l2_own_each(n, rank, cs, [&](int i, int c) {
    const float g = gs(i, c);
    Gp[i * ld + c] = g;
    GpT[i * ld + c] = gs(c, i);
    Xb[0][i * ld + c] = i == c ? dv[c] : 0.f;
    XTb[0][c * ld + i] = i == c ? dv[c] : 0.f;
    const float w = refine ? g : g * dv[c];
    Wb[0][i * ld + c] = w;
    WTb[0][c * ld + i] = w;
  });
  l2_fence_proxy_global();
  NS_PROF(NSL_SETUP)
  l2_barrier(cluster);
  NS_PROF(NSL_BARRIER)

  float em = 1.0f;  // E = I before the first iteration
  const int n_om = (refine || !omega) ? 0 : min(4, max(0, iters - 4));
  const int n_fused = fuse_xw ? max(0, iters - 2) : 0;
  NS_PROF_LOOP(0)
  for (int it = 0; it < iters; ++it) {
    const float om = it < n_om ? 1.5f : 1.0f;
    const bool split = it < mid_iters;
    const bool fused = it < n_fused;
    const int cur = it & 1, nxt = cur ^ 1;
    if (!fused) {  // W[:, own] = G' X[:, own], read by this CTA only
      float* Wc = Wb[cur];
      l2_tprod_any(split, n, L2M_GPT, L2M_X + cur, mA, mB, mat0, ld, rank,
                   cs, L2_B_UPPER, ring, L2NoOld(),
                   [&](int i, int c, float v, float) { Wc[i * ld + c] = v; });
      __syncthreads();
      NS_PROF(NSL_W_PRODUCT)
    }
    // E[:, own] = I - X^T W[:, own]; C[:, own] = triu(E, 1) + diag(E) / 2.
    em = 0.f;
    l2_tprod_any(split, n, L2M_X + cur, L2M_W + cur, mA, mB, mat0, ld, rank,
                 cs, L2_A_LOWER, ring, L2NoOld(),
                 [&](int i, int c, float v, float) {
                   const float e = (i == c ? 1.f : 0.f) - v;
                   em = nan_max(em, fabsf(e));
                   Cb[i * ld + c] = c > i ? e : (c == i ? e * 0.5f : 0.f);
                 });
    __syncthreads();
    NS_PROF(NSL_CORRECTION)
    // X[:, own] <- X[:, own] + om X C[:, own] (and W alike), with their
    // transposes' own rows, into the other buffers: the others still read
    // these whole.
    {
      const float* Xc = Xb[cur];
      float* Xn = Xb[nxt];
      float* XTn = XTb[nxt];
      l2_tprod_any(split, n, L2M_XT + cur, L2M_C, mA, mB, mat0, ld, rank,
                   cs, L2_A_UPPER | L2_B_UPPER, ring,
                   [&](int i, int c) { return __ldcg(Xc + i * ld + c); },
                   [&](int i, int c, float v, float x0) {
                     const float x = x0 + om * v;
                     Xn[i * ld + c] = x;
                     XTn[c * ld + i] = x;
                   });
    }
    NS_PROF(NSL_X_UPDATE)
    if (fused) {
      const float* Wc = Wb[cur];
      float* Wn = Wb[nxt];
      float* WTn = WTb[nxt];
      l2_tprod_any(split, n, L2M_WT + cur, L2M_C, mA, mB, mat0, ld, rank,
                   cs, L2_B_UPPER, ring,
                   [&](int i, int c) { return __ldcg(Wc + i * ld + c); },
                   [&](int i, int c, float v, float w0) {
                     const float w = w0 + om * v;
                     Wn[i * ld + c] = w;
                     WTn[c * ld + i] = w;
                   });
    }
    NS_PROF(NSL_W_UPDATE)
    l2_barrier(cluster);
    NS_PROF(NSL_BARRIER)
  }
  NS_PROF_LOOP(1)

  const int fin = iters & 1;
  const float* Xf = Xb[fin];
  if (refine) {  // the exact final residual E = I - X^T G' X
    float* Wf = Wb[fin];
    l2_tprod_any(false, n, L2M_GPT, L2M_X + fin, mA, mB, mat0, ld, rank, cs,
                 L2_B_UPPER, ring, L2NoOld(),
                 [&](int i, int c, float v, float) { Wf[i * ld + c] = v; });
    __syncthreads();
    NS_PROF(NSL_W_PRODUCT)
    em = 0.f;
    l2_tprod_any(false, n, L2M_X + fin, L2M_W + fin, mA, mB, mat0, ld, rank,
                 cs, L2_A_LOWER, ring, L2NoOld(),
                 [&](int i, int c, float v, float) {
                   em = nan_max(em, fabsf((i == c ? 1.f : 0.f) - v));
                 });
    NS_PROF(NSL_CORRECTION)
  }
  // t[:, own] = X^T G'[:, own].
  l2_tprod_any(false, n, L2M_X + fin, L2M_GP, mA, mB, mat0, ld, rank, cs,
               L2_A_LOWER, ring, L2NoOld(),
               [&](int i, int c, float v, float) {
                 t[(size_t)i * ldt + c] = (c >= i || !triu_t) ? v : 0.f;
               });
  NS_PROF(NSL_CLOSE_T)
  l2_own_each(n, rank, cs, [&](int i, int c) {
    X[(size_t)i * n + c] = __ldcg(Xf + i * ld + c);
  });
  NS_PROF(NSL_X_STORE)
  l2_cluster_max(cluster, em, red, cred, resid_mode, resid);
  NS_PROF(NSL_CLUSTER_MAX)
  NS_PROF_SAVE(g_ns_l2_prof)
}

// Instantiation of the shared-memory route for width r (the smallest of
// 32, 64, 128 that holds it), or 0: the L2 route (ns.py::_inst).
static inline int chain_inst(int r) {
  return r <= 32 ? 32 : r <= 64 ? 64 : r <= 128 ? 128 : 0;
}

// Most CTAs of an L2-route cluster for width r (ns.py::_l2_ctas).
static inline int l2_max_ctas(int r) {
  return std::min(kL2MaxCluster, (r + kStripe - 1) / kStripe);
}

// A chain kernel's launch layout, as ops/kernels/ns.py's layout rules give
// it (NsLayout): instantiation (0 on the L2 route), route (0 shared
// memory, 1 L2), CTAs, floats of global scratch, dynamic shared bytes.
struct KernelLayout {
  int inst, route, ctas, scratch_floats, smem_bytes;
};

static inline int chain_smem_bytes(int r) {
  switch (chain_inst(r)) {
    case 32: return ChainLayout<32>::BYTES;
    case 64: return ChainLayout<64>::BYTES;
    case 128: return ChainLayout<128>::BYTES;
    default:
      return (kL2RingSlack + kL2RingFloats + 3 * r + 64 +
              kNormSlots * kL2MaxCluster) * 4;
  }
}

// Whether `lay` is the chain's layout for width r (ns.py::ns_layout): the
// shared-memory route's fixed cluster of inst / 16 CTAs, or the L2 route
// on 1 .. l2_max_ctas(r) CTAs.
static inline bool chain_layout_ok(int r, const KernelLayout& lay) {
  if (r < 1 || r > kMaxWidth) return false;
  const int inst = chain_inst(r);
  if (lay.inst != inst || lay.route != (inst ? 0 : 1) ||
      lay.smem_bytes != chain_smem_bytes(r))
    return false;
  if (inst) return lay.ctas == inst / kStripe && lay.scratch_floats == 0;
  return lay.ctas >= 1 && lay.ctas <= l2_max_ctas(r) &&
         lay.scratch_floats == chain_l2_scratch_floats(r);
}

typedef CUresult (*L2EncodeFn)(CUtensorMap*, CUtensorMapDataType,
                               cuuint32_t, void*, const cuuint64_t*,
                               const cuuint64_t*, const cuuint32_t*,
                               const cuuint32_t*, CUtensorMapInterleave,
                               CUtensorMapSwizzle, CUtensorMapL2promotion,
                               CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the process has already
// loaded; nullptr if it cannot be found.
static inline L2EncodeFn l2_encode_fn() {
  static L2EncodeFn fn = nullptr;
  if (!fn) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (h)
      fn = reinterpret_cast<L2EncodeFn>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// An L2 kernel's scratch of `batch` members (`mats` matrices of n x
// l2_ld(n) floats each a member, back to back; 16-byte aligned) as one 3-D
// tensor (columns, rows, matrix): mapA in boxes of kL2Box columns x
// kL2UDepth rows with the 128B swizzle (l2_a_at), mapB in kL2Tile columns
// x kL2UDepth rows, unswizzled.  Rows past n, and columns past the padded
// row, arrive as zeros.
static inline cudaError_t l2_maps(float* scratch, int n, int batch, int mats,
                                  CUtensorMap* mapA, CUtensorMap* mapB) {
  const L2EncodeFn fn = l2_encode_fn();
  if (!fn) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return cudaErrorInvalidValue;
  const int ld = l2_ld(n);
  const cuuint64_t dims[3] = {(cuuint64_t)ld, (cuuint64_t)n,
                              (cuuint64_t)mats * batch};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4,
                                 (cuuint64_t)n * ld * 4};
  const cuuint32_t boxA[3] = {kL2Box, kL2UDepth, 1};
  const cuuint32_t boxB[3] = {kL2Tile, kL2UDepth, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  if (fn(mapA, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, scratch, dims, strides,
         boxA, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      fn(mapB, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, scratch, dims, strides,
         boxB, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int R>
static inline cudaError_t launch_chain_r(cudaStream_t st, const float* G,
                                         int nr, float* X, float* t, int ldt,
                                         float* resid, int iters, float shift,
                                         int refine, int mid_iters, int omega,
                                         int fuse_xw, int triu_t,
                                         int resid_mode, int batch,
                                         const ChainBatch& bt) {
  using L = ChainLayout<R>;
  static bool fits[2] = {false, false};
  return launch_cluster_batch(
      nr == R ? &chain_kernel<R, false> : &chain_kernel<R, true>, L::CS,
      batch, L::BYTES, st, fits[nr != R], G, nr, X, t, ldt, resid, iters,
      shift, refine, mid_iters, omega, fuse_xw, triu_t, resid_mode, bt);
}

// Launch the chain for width r (1 .. kMaxWidth) on `st` with the layout
// `lay` (checked by the caller: chain_layout_ok): G (r x r, fp32,
// row-major) -> X (r x r), t (leading dimension ldt) and *resid, all
// device pointers; `scratch` holds lay.scratch_floats (the L2 route's
// operands).  With `batch` > 1 one launch runs that many members, at the
// strides of `bt` (the scratch's included).  Returns the launch's error.
static inline cudaError_t launch_chain(int r, const KernelLayout& lay,
                                       float* scratch, cudaStream_t st,
                                       const float* G, float* X, float* t,
                                       int ldt, float* resid, int iters,
                                       float shift, int refine, int mid_iters,
                                       int omega, int fuse_xw, int triu_t,
                                       int resid_mode, int batch = 1,
                                       const ChainBatch& bt = ChainBatch{}) {
#define MPBQR_CHAIN(RR)                                                      \
  return launch_chain_r<RR>(st, G, r, X, t, ldt, resid, iters, shift,        \
                            refine, mid_iters, omega, fuse_xw, triu_t,       \
                            resid_mode, batch, bt)
  switch (lay.inst) {
    case 32: MPBQR_CHAIN(32);
    case 64: MPBQR_CHAIN(64);
    case 128: MPBQR_CHAIN(128);
    default: break;
  }
#undef MPBQR_CHAIN
  CUtensorMap mapA, mapB;
  if (batch > 1 && bt.scratch != chain_l2_scratch_floats(r))
    return cudaErrorInvalidValue;  // the maps see the members back to back
  cudaError_t err = l2_maps(scratch, r, batch, kL2Mats, &mapA, &mapB);
  if (err != cudaSuccess) return err;
  static bool fits[kL2MaxCluster + 1] = {};
  return launch_cluster_batch(chain_l2_kernel, lay.ctas, batch,
                              lay.smem_bytes, st, fits[lay.ctas], G, r, X, t,
                              ldt, resid, iters, shift, refine, mid_iters,
                              omega, fuse_xw, triu_t, resid_mode, scratch,
                              bt, mapA, mapB);
}

// How many of the chain's clusters for width r with the layout `lay`
// (checked by the caller) the card keeps resident at once, in *out.
static inline cudaError_t chain_resident(int r, const KernelLayout& lay,
                                         int* out) {
  switch (lay.inst) {
#define MPBQR_RES(RR)                                                        \
  case RR:                                                                   \
    return cluster_resident(r == RR ? &chain_kernel<RR, false>               \
                                    : &chain_kernel<RR, true>,               \
                            ChainLayout<RR>::CS, ChainLayout<RR>::BYTES, out)
    MPBQR_RES(32);
    MPBQR_RES(64);
    MPBQR_RES(128);
#undef MPBQR_RES
    default: break;
  }
  return cluster_resident(chain_l2_kernel, lay.ctas, lay.smem_bytes, out);
}

}  // namespace mpbqr
