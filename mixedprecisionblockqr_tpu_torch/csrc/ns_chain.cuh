// Device-side triangular Newton-Schulz chain shared by the ns_chain and
// bgs_group_fused kernels.
//
// Replaces the in-kernel chain of mixedprecisionblockqr_tpu/ops/pallas/ns.py
// (_tri_ns, _norm2_est, _ns_kernel).  On the TPU the whole r x r chain sits
// in VMEM next to a 128 x 128 matrix unit.  On Hopper one r x r fp32 operand
// is 64 KB at r = 128 and the chain needs about five of them, more than the
// 227 KB of shared memory a block can use.  So one CTA of 256 threads runs
// the whole chain and keeps its operands in global scratch, which stays in
// the 50 MB L2; each r x r product streams 16-deep k-slices through shared
// memory.
//
// What bounds it: the chain is a strictly sequential string of r x r
// products (3 per iteration), so it is latency-bound, not FLOP- or
// byte-bound.  This first design does every product as true fp32 FMA on one
// SM (never TF32 mma), so a 128^3 product costs ~2M FMA on one SM's 128
// lanes.  Spreading a chain over a thread-block cluster, and wgmma for the
// bf16-split iterations, are later work.
//
// Precision modes of a product (mirroring the JAX dots):
//   MODE_F32   : fp32 operands, fp32 FMA             (Precision.HIGHEST)
//   MODE_BF16  : operands rounded to bf16 on load     (single-pass bf16 dot)
//   MODE_SPLIT : two-term bf16 Dekker split, hi*hi + hi*lo + lo*hi with fp32
//                accumulation (emulated Precision.HIGH, ns.py::_split_bf16).
//                Each bf16 x bf16 product is exact in fp32.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>

namespace mpbqr {

constexpr int kChainThreads = 256;
constexpr int kKT = 16;  // k-depth of one shared-memory slice

enum { MODE_F32 = 0, MODE_BF16 = 1, MODE_SPLIT = 2 };
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

// Shared memory of one chain CTA.
template <int R>
struct ChainSmem {
  float ah[kKT * R], al[kKT * R], bh[kKT * R], bl[kKT * R];
  float v0[R], v1[R], v2[R];
  float red[32];
};

// out = op(A) @ B for r x r row-major matrices, op(A) = A^T when `ta`.
// `out` must alias neither operand.  Each thread owns the outputs
// (ty + 16 a, tx + 16 b), a, b < R / 16.
template <int R, int MODE>
__device__ void blk_mm(float* out, const float* A, bool ta, const float* B,
                       ChainSmem<R>& sm) {
  constexpr int TM = R / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[TM][TM];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TM; ++b) acc[a][b] = 0.f;

  for (int k0 = 0; k0 < R; k0 += kKT) {
    for (int e = threadIdx.x; e < kKT * R; e += kChainThreads) {
      int i, k;
      float av;
      if (ta) {  // A^T[i][k] = A[k][i]: contiguous along i
        k = e / R;
        i = e % R;
        av = A[(k0 + k) * R + i];
      } else {   // A[i][k]: contiguous along k
        i = e / kKT;
        k = e % kKT;
        av = A[i * R + k0 + k];
      }
      const int kb = e / R, j = e % R;
      const float bv = B[(k0 + kb) * R + j];
      if (MODE == MODE_F32) {
        sm.ah[k * R + i] = av;
        sm.bh[kb * R + j] = bv;
      } else {
        const float ahi = bf16_round(av), bhi = bf16_round(bv);
        sm.ah[k * R + i] = ahi;
        sm.bh[kb * R + j] = bhi;
        if (MODE == MODE_SPLIT) {
          sm.al[k * R + i] = bf16_round(av - ahi);
          sm.bl[kb * R + j] = bf16_round(bv - bhi);
        }
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kKT; ++k) {
      float ra[TM], rb[TM];
#pragma unroll
      for (int a = 0; a < TM; ++a) ra[a] = sm.ah[k * R + ty + 16 * a];
#pragma unroll
      for (int b = 0; b < TM; ++b) rb[b] = sm.bh[k * R + tx + 16 * b];
      if (MODE == MODE_SPLIT) {
        float la[TM], lb[TM];
#pragma unroll
        for (int a = 0; a < TM; ++a) la[a] = sm.al[k * R + ty + 16 * a];
#pragma unroll
        for (int b = 0; b < TM; ++b) lb[b] = sm.bl[k * R + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < TM; ++a)
#pragma unroll
          for (int b = 0; b < TM; ++b) {
            acc[a][b] = fmaf(ra[a], rb[b], acc[a][b]);
            acc[a][b] = fmaf(ra[a], lb[b], acc[a][b]);
            acc[a][b] = fmaf(la[a], rb[b], acc[a][b]);
          }
      } else {
#pragma unroll
        for (int a = 0; a < TM; ++a)
#pragma unroll
          for (int b = 0; b < TM; ++b)
            acc[a][b] = fmaf(ra[a], rb[b], acc[a][b]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TM; ++b)
      out[(ty + 16 * a) * R + tx + 16 * b] = acc[a][b];
  __syncthreads();
}

template <int R>
__device__ void blk_mm_mode(float* out, const float* A, bool ta,
                            const float* B, int mode, ChainSmem<R>& sm) {
  if (mode == MODE_SPLIT)
    blk_mm<R, MODE_SPLIT>(out, A, ta, B, sm);
  else if (mode == MODE_BF16)
    blk_mm<R, MODE_BF16>(out, A, ta, B, sm);
  else
    blk_mm<R, MODE_F32>(out, A, ta, B, sm);
}

// Upper estimate of ||M||_2: 1.05 x two power-iteration steps, computed
// scale-normalized (ns.py::_norm2_est) so that ||M|| >~ 3e8 cannot
// overflow the sum of squares.
template <int R>
__device__ float blk_norm2_est(const float* M, ChainSmem<R>& sm) {
  float m = 0.f;
  for (int e = threadIdx.x; e < R * R; e += kChainThreads)
    m = nan_max(m, fabsf(M[e]));
  m = blk_max(m, sm.red);
  const float a = nan_max(m, FLT_MIN);
  const float inv = 1.0f / a;
  const int i = threadIdx.x;
  if (i < R) {
    float s = 0.f;
    for (int j = 0; j < R; ++j) s += M[i * R + j] * inv;
    sm.v0[i] = s;
  }
  __syncthreads();
  float q = 0.f;
  if (i < R) {
    float s = 0.f;
    for (int j = 0; j < R; ++j) s = fmaf(M[i * R + j] * inv, sm.v0[j], s);
    sm.v1[i] = s;
    q = s * s;
  }
  const float n1 = sqrtf(blk_sum(q, sm.red));
  const float sc = 1.0f / (n1 + 1e-30f);
  q = 0.f;
  if (i < R) {
    float s = 0.f;
    for (int j = 0; j < R; ++j)
      s = fmaf(M[i * R + j] * inv, sm.v1[j] * sc, s);
    q = s * s;
  }
  return (1.05f * a) * sqrtf(blk_sum(q, sm.red));
}

// E = I - Tm and C = triu(E, 1) + diag(E) / 2 in one pass.
template <int R>
__device__ void blk_correction(const float* Tm, float* E, float* C) {
  for (int e = threadIdx.x; e < R * R; e += kChainThreads) {
    const int i = e / R, j = e % R;
    const float v = (i == j ? 1.f : 0.f) - Tm[e];
    E[e] = v;
    C[e] = j > i ? v : (j == i ? v * 0.5f : 0.f);
  }
  __syncthreads();
}

// Y += om * D elementwise.
template <int R>
__device__ void blk_axpy(float* Y, float om, const float* D) {
  for (int e = threadIdx.x; e < R * R; e += kChainThreads) Y[e] += om * D[e];
  __syncthreads();
}

// The triangular NS chain on an SPD G (ns.py::_tri_ns): returns X in `X`
// and the last correction E in `E` (one step behind, or, for `refine`
// chains, the exact post-loop residual I - X^T G X).  `refine` seeds X = I
// for Grams near I.  Scratch: W, C, Tm (r x r each).
// The first `mid_iters` iterations run the bf16-split products.  With
// fuse_xw, all but the final two iterations carry W = G X by the stacked
// right-multiplication [X; W] <- [X; W](I + om C); the final two run the
// classic form with a fresh W = G X.
template <int R>
__device__ void blk_tri_ns(const float* G, float* X, float* W, float* E,
                           float* C, float* Tm, int iters, bool refine,
                           int mid_iters, bool omega, bool fuse_xw,
                           ChainSmem<R>& sm) {
  if (refine) {
    for (int e = threadIdx.x; e < R * R; e += kChainThreads) {
      X[e] = (e / R == e % R) ? 1.f : 0.f;
      W[e] = G[e];
    }
    __syncthreads();
  } else {
    // Jacobi scaling d = diag(G)^-1/2, then the spectral guard on
    // M0 = D G D (held in E as a temporary).
    if (threadIdx.x < R) {
      const float d = G[threadIdx.x * R + threadIdx.x];
      sm.v2[threadIdx.x] = 1.0f / sqrtf(nan_max(d, FLT_MIN));
    }
    __syncthreads();
    for (int e = threadIdx.x; e < R * R; e += kChainThreads) {
      const int i = e / R, j = e % R;
      E[e] = G[e] * sm.v2[i] * sm.v2[j];
    }
    __syncthreads();
    const float scale = 1.0f / sqrtf(blk_norm2_est<R>(E, sm));
    for (int e = threadIdx.x; e < R * R; e += kChainThreads) {
      const int i = e / R, j = e % R;
      const float dj = sm.v2[j] * scale;
      X[e] = (i == j) ? dj : 0.f;
      W[e] = G[e] * dj;
    }
    __syncthreads();
  }
  const int n_om = (refine || !omega) ? 0 : min(4, max(0, iters - 4));
  const int n_fused = fuse_xw ? max(0, iters - 2) : 0;
  for (int e = threadIdx.x; e < R * R; e += kChainThreads)
    E[e] = (e / R == e % R) ? 1.f : 0.f;
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    const float om = it < n_om ? 1.5f : 1.0f;
    const int mode = it < mid_iters ? MODE_SPLIT : MODE_F32;
    if (it < n_fused) {
      blk_mm_mode<R>(Tm, X, true, W, mode, sm);
      blk_correction<R>(Tm, E, C);
      blk_mm_mode<R>(Tm, X, false, C, mode, sm);
      blk_axpy<R>(X, om, Tm);
      blk_mm_mode<R>(Tm, W, false, C, mode, sm);
      blk_axpy<R>(W, om, Tm);
    } else {
      blk_mm_mode<R>(W, G, false, X, mode, sm);
      blk_mm_mode<R>(Tm, X, true, W, mode, sm);
      blk_correction<R>(Tm, E, C);
      blk_mm_mode<R>(Tm, X, false, C, mode, sm);
      blk_axpy<R>(X, om, Tm);
    }
  }
  if (refine) {
    blk_mm<R, MODE_F32>(W, G, false, X, sm);
    blk_mm<R, MODE_F32>(Tm, X, true, W, sm);
    blk_correction<R>(Tm, E, C);
  }
}

// One whole chain (ns.py::_ns_kernel) in one CTA of kChainThreads threads:
//   G' = G + shift * ||G||_2-estimate * I   (when shift != 0)
//   X, E = tri_ns(G')
//   t = X^T G'         written with leading dimension ldt, upper triangle
//                      only with triu_t (the robust passes keep the full
//                      product and truncate once, after combining them)
//   *resid = max|E|, reported per resid_mode.
// Scratch: 5 r x r floats (G', W, E, C, Tm).
template <int R>
__global__ void __launch_bounds__(kChainThreads)
chain_kernel(const float* G, float* X, float* t, int ldt, float* resid,
             float* scr, int iters, float shift, int refine, int mid_iters,
             int omega, int fuse_xw, int triu_t, int resid_mode) {
  __shared__ ChainSmem<R> sm;
  float* Gs = scr;
  float* W = scr + R * R;
  float* E = scr + 2 * R * R;
  float* C = scr + 3 * R * R;
  float* Tm = scr + 4 * R * R;
  const float* Gp = G;
  if (shift != 0.f) {
    const float s = shift * blk_norm2_est<R>(G, sm);
    for (int e = threadIdx.x; e < R * R; e += kChainThreads)
      Gs[e] = G[e] + ((e / R == e % R) ? s : 0.f);
    __syncthreads();
    Gp = Gs;
  }
  blk_tri_ns<R>(Gp, X, W, E, C, Tm, iters, refine != 0, mid_iters,
                omega != 0, fuse_xw != 0, sm);
  // X^{-1} = X^T G' at convergence: R recovered with no solve.
  blk_mm<R, MODE_F32>(Tm, X, true, Gp, sm);
  for (int e = threadIdx.x; e < R * R; e += kChainThreads) {
    const int i = e / R, j = e % R;
    t[i * ldt + j] = (j >= i || !triu_t) ? Tm[e] : 0.f;
  }
  float m = 0.f;
  for (int e = threadIdx.x; e < R * R; e += kChainThreads)
    m = nan_max(m, fabsf(E[e]));
  m = blk_max(m, sm.red);
  if (threadIdx.x == 0) {
    if (resid_mode == RESID_SQUARE) m = m * m;
    else if (resid_mode == RESID_SCALE) m = m * 0.01f;
    *resid = m;
  }
}

// Launch the chain kernel for a runtime r in {32, 64, 128}; false if r is
// not one of them.
static inline bool launch_chain(int r, cudaStream_t st, const float* G,
                                float* X, float* t, int ldt, float* resid,
                                float* scr, int iters, float shift, int refine,
                                int mid_iters, int omega, int fuse_xw,
                                int triu_t, int resid_mode) {
#define MPBQR_CHAIN(RR)                                                      \
  chain_kernel<RR><<<1, kChainThreads, 0, st>>>(                             \
      G, X, t, ldt, resid, scr, iters, shift, refine, mid_iters, omega,      \
      fuse_xw, triu_t, resid_mode)
  switch (r) {
    case 32: MPBQR_CHAIN(32); return true;
    case 64: MPBQR_CHAIN(64); return true;
    case 128: MPBQR_CHAIN(128); return true;
    default: return false;
  }
#undef MPBQR_CHAIN
}

}  // namespace mpbqr
