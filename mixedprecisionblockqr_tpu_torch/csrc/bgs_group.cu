// K2: one whole Block Gram-Schmidt group -- g sequential panel
// factorizations (Gram, NS chain, Q = P X, t) plus the eager in-group
// projections C -= Qk (Qk^T C), with the shifted three-pass chain on
// robust tail panels.
//
// Replaces mixedprecisionblockqr_tpu/ops/pallas/ns.py::bgs_group_fused
// (_bgs_group_fused_jit -> pl.pallas_call of _bgs_group_kernel, with
// _group_loop, _tri_ns_panel and _robust_spill).
//
// The TPU kernel keeps the whole m x g*r group (8 MB at the 2048 x 1024
// headline) and the 4 MB Rg in VMEM.  No SM holds that, so this port is one
// C entry point that issues, on the caller's stream, a fixed sequence of
// kernels per panel j:
//   * the tall Gram P^T P, split over m into 256-row chunks, with a
//     deterministic second-pass reduction (no atomics);
//   * the device NS chain of ns_chain.cuh (one CTA);
//   * Q = P X into a scratch panel, then copied into the panel's slot;
//   * t = triu(X^T G) straight into Rg's diagonal block;
//   * the eager projection pair G1 = Qk^T C (written to Rg's row block) and
//     C -= Qk G1, in place over the group's remaining columns;
//   * for robust panels, the three-pass chain of
//     _tri_ns_panel(robust=True), spilling Q1 / Q2 through scratch panels.
// What bounds it: at g*r <= 1024 the tall products are memory-bound
// (each reads the m x r panel and the m x c trailing block once per
// panel), and the r x r chains are latency-bound on one SM.  The simple
// tiled fp32-FMA GEMM below (64 x 64 tiles, bf16 rounding on load when
// asked) keeps every product inside this source, as the TPU kernel
// computes them in its own body.  Fusing the sequence into one persistent
// or cluster kernel with wgmma and TMA is later work.
#include <algorithm>

#include "ns_chain.cuh"

namespace mpbqr {

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kGemmThreads = 256;
constexpr int kSplitRows = 256;  // m-chunk of one split-K partial
// Chain schedule of the group, the same constants as ops/kernels/ns.py
// (MID_FINAL, ROBUST_ITERS): with chain_mid, all but the final kMidFinal
// iterations of a non-refine chain run the bf16-split products; robust
// panels run passes of kRobustIt1 / kRobustIt2 / kRobustIt3 iterations.
constexpr int kMidFinal = 2;
constexpr int kRobustIt1 = 14, kRobustIt2 = 12, kRobustIt3 = 4;

// C = op(A) @ B (sub == 0) or C -= op(A) @ B (sub == 1) for an M x N
// output with inner dimension K; op(A) = A^T (A stored K x M) when TA.
// With gridDim.z > 1 each z-slice takes K rows [z*kch, (z+1)*kch) and
// writes its partial product to C + z*M*N with leading dimension N.
template <bool TA, bool BF>
__global__ void __launch_bounds__(kGemmThreads)
tall_gemm(int M, int N, int K, const float* A, int lda, const float* B,
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
        v = TA ? A[(long long)(k0 + k) * lda + i0 + i]
               : A[(long long)(i0 + i) * lda + k0 + k];
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
__global__ void splitk_reduce(const float* part, int S, int M, int N,
                              float* C, int ldc) {
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
  blk_mm<R, MODE_F32>(A, T2, false, T1, sm);
  blk_mm<R, MODE_F32>(B, T3, false, A, sm);
  for (int e = threadIdx.x; e < R * R; e += kChainThreads) {
    const int i = e / R, j = e % R;
    out[i * ldo + j] = j >= i ? B[e] : 0.f;
  }
}

// worst = max(0, resid[0], ..., resid[g-1]), NaN-propagating.
__global__ void worst_resid(const float* resid, int g, float* worst) {
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    float w = 0.f;
    for (int j = 0; j < g; ++j) w = nan_max(w, resid[j]);
    *worst = w;
  }
}

struct GroupScratch {
  float *chain, *G, *X1, *X2, *X3, *T1, *T2, *T3, *tmpA, *tmpB, *resid,
      *part;
};

static long long split_count(int m) { return (m + kSplitRows - 1) / kSplitRows; }

static long long group_scratch_floats(int m, int r, int g, GroupScratch* s,
                                      float* base) {
  const long long rr = (long long)r * r, mr = (long long)m * r;
  const long long w = (long long)g * r;
  long long off = 0;
  auto take = [&](float** p, long long n) {
    if (s) *p = base + off;
    off += n;
  };
  GroupScratch dummy;
  GroupScratch* d = s ? s : &dummy;
  take(&d->chain, 5 * rr);
  take(&d->G, rr);
  take(&d->X1, rr);
  take(&d->X2, rr);
  take(&d->X3, rr);
  take(&d->T1, rr);
  take(&d->T2, rr);
  take(&d->T3, rr);
  take(&d->tmpA, mr);
  take(&d->tmpB, mr);
  take(&d->resid, ((g + 31) / 32) * 32);
  take(&d->part, split_count(m) * r * w);
  return off;
}

// op(A) @ B into C (or C -= ... with sub, only for the non-transposed
// form).  The transposed form runs split-K through `part`.
static void gemm(cudaStream_t st, bool ta, bool bf, int M, int N, int K,
                 const float* A, int lda, const float* B, int ldb, float* C,
                 int ldc, bool sub, float* part) {
  const dim3 blk(kGemmThreads);
  if (ta) {
    const int S = (int)split_count(K);
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, S);
    if (bf)
      tall_gemm<true, true><<<grid, blk, 0, st>>>(M, N, K, A, lda, B, ldb,
                                                  part, N, kSplitRows, 0);
    else
      tall_gemm<true, false><<<grid, blk, 0, st>>>(M, N, K, A, lda, B, ldb,
                                                   part, N, kSplitRows, 0);
    const long long n = (long long)M * N;
    const int nb = (int)std::min<long long>((n + 255) / 256, 1024);
    splitk_reduce<<<nb, 256, 0, st>>>(part, S, M, N, C, ldc);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, 1);
    if (bf)
      tall_gemm<false, true><<<grid, blk, 0, st>>>(M, N, K, A, lda, B, ldb,
                                                   C, ldc, K, sub ? 1 : 0);
    else
      tall_gemm<false, false><<<grid, blk, 0, st>>>(M, N, K, A, lda, B, ldb,
                                                    C, ldc, K, sub ? 1 : 0);
  }
}

static bool launch_combine(int r, cudaStream_t st, const float* T1,
                           const float* T2, const float* T3, float* out,
                           int ldo, float* scr) {
  switch (r) {
    case 32: tri_combine<32><<<1, kChainThreads, 0, st>>>(T1, T2, T3, out, ldo, scr); return true;
    case 64: tri_combine<64><<<1, kChainThreads, 0, st>>>(T1, T2, T3, out, ldo, scr); return true;
    case 128: tri_combine<128><<<1, kChainThreads, 0, st>>>(T1, T2, T3, out, ldo, scr); return true;
    default: return false;
  }
}

}  // namespace mpbqr

extern "C" {

// Floats of global scratch that mpbqr_bgs_group needs.
long long mpbqr_bgs_group_scratch_floats(int m, int r, int g) {
  return mpbqr::group_scratch_floats(m, r, g, nullptr, nullptr);
}

// P (m x g*r, fp32, row-major, read only) -> Q (m x g*r, may equal P),
// Rg (g*r x g*r, block upper) and *worst (one float), all device pointers.
// iters[j] / robust[j] are host arrays of g entries.  bf16_gram rounds the
// Gram and Q = P X operands to bf16, bf16_dots the projection operands;
// chain_mid runs the early chain iterations with bf16-split products.
// Returns the first CUDA error met, or cudaErrorInvalidValue for an r the
// chain kernel does not take.
int mpbqr_bgs_group(const float* P, float* Q, float* Rg, float* worst,
                    float* scratch, int m, int r, int g, const int* iters,
                    const int* robust, int bf16_dots, int bf16_gram,
                    int chain_mid, void* stream) {
  using namespace mpbqr;
  if (r != 32 && r != 64 && r != 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int w = g * r;
  GroupScratch s;
  group_scratch_floats(m, r, g, &s, scratch);
  auto mid = [&](int it) {
    return chain_mid ? std::max(0, it - kMidFinal) : 0;
  };
  cudaError_t err;
  if (Q != P) {
    err = cudaMemcpyAsync(Q, P, sizeof(float) * (size_t)m * w,
                          cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaMemsetAsync(Rg, 0, sizeof(float) * (size_t)w * w, st);
  if (err != cudaSuccess) return (int)err;
  const bool bg = bf16_gram != 0, bd = bf16_dots != 0;
  for (int j = 0; j < g; ++j) {
    const int c0 = j * r;
    float* Pj = Q + c0;
    float* Rjj = Rg + (size_t)c0 * w + c0;
    gemm(st, true, bg, r, r, m, Pj, w, Pj, w, s.G, r, false, s.part);
    if (!robust[j]) {
      launch_chain(r, st, s.G, s.X1, Rjj, w, s.resid + j, s.chain, iters[j],
                   0.f, 0, mid(iters[j]), 1, 1, 1, RESID_SQUARE);
      gemm(st, false, bg, m, r, r, Pj, w, s.X1, r, s.tmpA, r, false, s.part);
      err = cudaMemcpy2DAsync(Pj, sizeof(float) * w, s.tmpA,
                              sizeof(float) * r, sizeof(float) * r, m,
                              cudaMemcpyDeviceToDevice, st);
      if (err != cudaSuccess) return (int)err;
    } else {
      // Pass 1: shifted Gram (condition capped), t1 = X1^T Gs in full.
      launch_chain(r, st, s.G, s.X1, s.T1, r, s.resid + j, s.chain,
                   kRobustIt1, 1e-3f, 0, mid(kRobustIt1), 0, 1, 0, RESID_RAW);
      gemm(st, false, bg, m, r, r, Pj, w, s.X1, r, s.tmpA, r, false, s.part);
      gemm(st, true, bg, r, r, m, s.tmpA, r, s.tmpA, r, s.G, r, false,
           s.part);
      // Pass 2 on the fresh Gram of Q1, t2 = X2^T M1 in full.
      launch_chain(r, st, s.G, s.X2, s.T2, r, s.resid + j, s.chain,
                   kRobustIt2, 0.f, 0, mid(kRobustIt2), 0, 1, 0, RESID_RAW);
      gemm(st, false, bg, m, r, r, s.tmpA, r, s.X2, r, s.tmpB, r, false,
           s.part);
      gemm(st, true, bg, r, r, m, s.tmpB, r, s.tmpB, r, s.G, r, false,
           s.part);
      // Pass 3: identity-seeded refine with the exact final residual.
      launch_chain(r, st, s.G, s.X3, s.T3, r, s.resid + j, s.chain,
                   kRobustIt3, 0.f, 1, 0, 1, 1, 0, RESID_SCALE);
      gemm(st, false, bg, m, r, r, s.tmpB, r, s.X3, r, Pj, w, false, s.part);
      launch_combine(r, st, s.T1, s.T2, s.T3, Rjj, w, s.chain);
    }
    if (j + 1 < g) {
      const int cn = w - c0 - r;
      float* Cp = Pj + r;
      float* G1 = Rjj + r;
      gemm(st, true, bd, r, cn, m, Pj, w, Cp, w, G1, w, false, s.part);
      gemm(st, false, bd, m, cn, r, Pj, w, G1, w, Cp, w, true, s.part);
    }
  }
  worst_resid<<<1, 32, 0, st>>>(s.resid, g, worst);
  return (int)cudaGetLastError();
}

}  // extern "C"
