// Tall-panel pieces shared by bgs_group.cu (K2, K5) and panel_qr.cu (K3): the
// tiled fp32-FMA GEMM with its split-K form, the deterministic split-K
// reduction, the robust three-pass R-block combine and the panel chain
// schedule.
//
// The GEMM is a simple 64 x 64-tile kernel (bf16 rounding on load when
// asked), so every product of a panel factorization stays inside this
// repository's sources, as the TPU kernels compute them in their own body.
// At r <= 128 the tall products are memory-bound (each reads the m x r
// panel once); wgmma and TMA are later work.
#pragma once

#include <algorithm>

#include "ns_chain.cuh"

namespace mpbqr {

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kGemmThreads = 256;
constexpr int kSplitRows = 256;  // m-chunk of one split-K partial
// Chain schedule of a panel, the same constants as ops/kernels/ns.py
// (MID_FINAL, ROBUST_ITERS): with chain_mid, all but the final kMidFinal
// iterations of a non-refine chain run the bf16-split products; robust
// panels run passes of kRobustIt1 / kRobustIt2 / kRobustIt3 iterations.
constexpr int kMidFinal = 2;
constexpr int kRobustIt1 = 14, kRobustIt2 = 12, kRobustIt3 = 4;

__device__ __forceinline__ float as_f32(float x) { return x; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// C = op(A) @ B (sub == 0) or C -= op(A) @ B (sub == 1) for an M x N
// output with inner dimension K; op(A) = A^T (A stored K x M) when TA.
// A holds fp32 or bf16 (AT), widened on load.
// With gridDim.z > 1 each z-slice takes K rows [z*kch, (z+1)*kch) and
// writes its partial product to C + z*M*N with leading dimension N.
template <bool TA, bool BF, typename AT>
__global__ void __launch_bounds__(kGemmThreads)
tall_gemm(int M, int N, int K, const AT* A, int lda, const float* B,
          int ldb, float* C, int ldc, int kch, int sub) {
  __shared__ float As[kBK][kBM];
  __shared__ float Bs[kBK][kBN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int i0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * kch;
  const int ke = min(K, kb + kch);
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += kBK) {
#pragma unroll
    for (int q = 0; q < (kBM * kBK) / kGemmThreads; ++q) {
      const int e = threadIdx.x + q * kGemmThreads;
      int i, k;
      if (TA) {
        k = e / kBM;
        i = e % kBM;
      } else {
        i = e / kBK;
        k = e % kBK;
      }
      float v = 0.f;
      if (i0 + i < M && k0 + k < ke)
        v = as_f32(TA ? A[(long long)(k0 + k) * lda + i0 + i]
                      : A[(long long)(i0 + i) * lda + k0 + k]);
      As[k][i] = BF ? bf16_round(v) : v;
      const int kk = e / kBN, j = e % kBN;
      float w = 0.f;
      if (j0 + j < N && k0 + kk < ke)
        w = B[(long long)(k0 + kk) * ldb + j0 + j];
      Bs[kk][j] = BF ? bf16_round(w) : w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float ra[4], rb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ra[a] = As[k][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) rb[b] = Bs[k][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(ra[a], rb[b], acc[a][b]);
    }
    __syncthreads();
  }
  float* out = C;
  int ld = ldc;
  if (gridDim.z > 1) {
    out = C + (long long)blockIdx.z * M * N;
    ld = N;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= M) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx + 16 * b;
      if (j >= N) continue;
      float* p = out + (long long)i * ld + j;
      if (sub && gridDim.z == 1)
        *p -= acc[a][b];
      else
        *p = acc[a][b];
    }
  }
}

// C[i, j] = sum over s (in order) of part[s, i, j]: the deterministic
// second pass of a split-K product.
static __global__ void splitk_reduce(const float* part, int S, int M,
                                     int N, float* C, int ldc) {
  const long long n = (long long)M * N;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < S; ++z) s += part[z * n + e];
    C[(e / N) * ldc + e % N] = s;
  }
}

// out = triu(T3 @ (T2 @ T1)) with leading dimension ldo: the robust
// three-pass R block (ns.py:_tri_ns_panel, robust branch).  T1..T3 are the
// full products X_k^T G_k, so this is the only truncation.  One CTA.
template <int R>
__global__ void __launch_bounds__(kChainThreads)
tri_combine(const float* T1, const float* T2, const float* T3, float* out,
            int ldo, float* scr) {
  __shared__ ChainSmem<R> sm;
  float* A = scr;
  float* B = scr + R * R;
  blk_mm<R>(A, T2, false, T1, sm);
  blk_mm<R>(B, T3, false, A, sm);
  for (int e = threadIdx.x; e < R * R; e += kChainThreads) {
    const int i = e / R, j = e % R;
    out[i * ldo + j] = j >= i ? B[e] : 0.f;
  }
}

static inline long long split_count(int m) {
  return (m + kSplitRows - 1) / kSplitRows;
}

// op(A) @ B into C (or C -= ... with sub, only for the non-transposed
// form).  The transposed form runs split-K through `part`.
template <typename AT>
static inline void gemm(cudaStream_t st, bool ta, bool bf, int M, int N,
                        int K, const AT* A, int lda, const float* B,
                        int ldb, float* C, int ldc, bool sub, float* part) {
  const dim3 blk(kGemmThreads);
  if (ta) {
    const int S = (int)split_count(K);
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, S);
    if (bf)
      tall_gemm<true, true, AT><<<grid, blk, 0, st>>>(
          M, N, K, A, lda, B, ldb, part, N, kSplitRows, 0);
    else
      tall_gemm<true, false, AT><<<grid, blk, 0, st>>>(
          M, N, K, A, lda, B, ldb, part, N, kSplitRows, 0);
    const long long n = (long long)M * N;
    const int nb = (int)std::min<long long>((n + 255) / 256, 1024);
    splitk_reduce<<<nb, 256, 0, st>>>(part, S, M, N, C, ldc);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, 1);
    if (bf)
      tall_gemm<false, true, AT><<<grid, blk, 0, st>>>(
          M, N, K, A, lda, B, ldb, C, ldc, K, sub ? 1 : 0);
    else
      tall_gemm<false, false, AT><<<grid, blk, 0, st>>>(
          M, N, K, A, lda, B, ldb, C, ldc, K, sub ? 1 : 0);
  }
}

static inline bool launch_combine(int r, cudaStream_t st, const float* T1,
                                  const float* T2, const float* T3,
                                  float* out, int ldo, float* scr) {
  switch (r) {
    case 32: tri_combine<32><<<1, kChainThreads, 0, st>>>(T1, T2, T3, out, ldo, scr); return true;
    case 64: tri_combine<64><<<1, kChainThreads, 0, st>>>(T1, T2, T3, out, ldo, scr); return true;
    case 128: tri_combine<128><<<1, kChainThreads, 0, st>>>(T1, T2, T3, out, ldo, scr); return true;
    default: return false;
  }
}

}  // namespace mpbqr
