// K9: upper Cholesky factor R (G = R^T R) of an SPD r x r fp32 matrix and
// its explicit inverse R^-1, r a multiple of 32, in one launch.
//
// Replaces mixedprecisionblockqr_tpu/ops/pallas/chol.py::chol_rinv
// (pl.pallas_call of _chol_inv_kernel).
//
// Same algorithm as the TPU kernel: right-looking blocked Cholesky on
// 32-wide diagonal blocks, whose 32-step column loop also builds the
// block's inverse row by row (bordered form); per block a row-panel solve
// R[k, k+1:] = Linv A[k, k+1:] and the trailing update A -= Rrow^T Rrow;
// then the block-row back-fill Rinv[k, k+1:] = -Rkk^-1 (R[k, k+1:]
// Rinv[k+1:, k+1:]), k descending.  Every product is true fp32 FMA.
//
// The TPU kernel keeps G's working copy, R and R^-1 in VMEM.  Three r x r
// fp32 arrays are 192 KB at r = 128 and 3 MB at r = 512, so only r <= 128
// would fit an SM's 227 KB of shared memory.  This kernel has one path for
// every r: the working copy (global scratch) and the outputs stay in
// global memory, where one CTA's traffic is served by the L2, and shared
// memory holds the 32 x 32 diagonal block with its factor and inverse, and
// the k-slices of the products.  One CTA of 256 threads: the column loop
// and the block sequence are strictly ordered, so the kernel is bound by
// latency (three barriers per column, r columns), not by its r^3 fp32
// operations or its 12 r^2 bytes.  Work the reference does and nothing
// reads is skipped: tiles of the trailing update strictly below the
// diagonal, and the zero part of the triangular operand in the back-fill.
//
// A pivot that is not positive gives sqrt(negative) = NaN, which spreads
// through the rest of R and R^-1 as in the reference: no error is raised.
// The strictly lower parts of R and R^-1 are exact zeros.
#include <cuda_runtime.h>

namespace mpbqr {

constexpr int kCB = 32;            // diagonal block
constexpr int kCM = 32, kCN = 128, kCK = 16;  // product tile
constexpr int kCholThreads = 256;

struct CholSmem {
  float As[kCK][kCM];
  float Bs[kCK][kCN];
  float Ab[kCB][kCB + 1], L[kCB][kCB + 1], Li[kCB][kCB + 1];
  float lv[kCB];
};

enum { MM_SET = 0, MM_SUB = 1, MM_NEG = 2 };

// C (M x N) = op(A) @ B, C -= op(A) @ B or C = -op(A) @ B by `mode`, with
// op(A) = A^T (A stored K x M) when TA; row-major, leading dimensions in
// floats; C aliases neither operand.  `skip_lower` leaves out the tiles
// that lie wholly below the diagonal of a square C; `b_upper` says that B
// is upper triangular, so output column j needs only k <= j.  Thread
// (ty, tx) of the 8 x 32 layout owns rows 4 ty.., columns 4 tx.. of each
// 32 x 128 tile.  Ends with a barrier.
template <bool TA>
__device__ void cta_mm(int M, int N, int K, const float* A, int lda,
                       const float* B, int ldb, float* C, int ldc, int mode,
                       bool skip_lower, bool b_upper, CholSmem& sm) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i0 = 0; i0 < M; i0 += kCM) {
    for (int j0 = 0; j0 < N; j0 += kCN) {
      if (skip_lower && i0 >= j0 + kCN) continue;
      const int ke = b_upper ? min(K, j0 + kCN) : K;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
      for (int k0 = 0; k0 < ke; k0 += kCK) {
        for (int e = threadIdx.x; e < kCM * kCK; e += kCholThreads) {
          int i, k;
          if (TA) {
            k = e / kCM;
            i = e % kCM;
          } else {
            i = e / kCK;
            k = e % kCK;
          }
          float v = 0.f;
          if (i0 + i < M && k0 + k < ke)
            v = TA ? A[(long long)(k0 + k) * lda + i0 + i]
                   : A[(long long)(i0 + i) * lda + k0 + k];
          sm.As[k][i] = v;
        }
        for (int e = threadIdx.x; e < kCK * kCN; e += kCholThreads) {
          const int k = e / kCN, j = e % kCN;
          float v = 0.f;
          if (j0 + j < N && k0 + k < ke)
            v = B[(long long)(k0 + k) * ldb + j0 + j];
          sm.Bs[k][j] = v;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kCK; ++k) {
          float ra[4], rb[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            ra[c] = sm.As[k][4 * ty + c];
            rb[c] = sm.Bs[k][4 * tx + c];
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[a][b] = fmaf(ra[a], rb[b], acc[a][b]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + 4 * ty + a;
        if (i >= M) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = j0 + 4 * tx + b;
          if (j >= N) continue;
          float* p = C + (long long)i * ldc + j;
          if (mode == MM_SUB)
            *p -= acc[a][b];
          else
            *p = mode == MM_NEG ? -acc[a][b] : acc[a][b];
        }
      }
    }
  }
  __syncthreads();
}

// Factor the 32 x 32 diagonal block of the working copy at `base`:
// L (lower, block = L L^T) and Linv, by the reference's column loop;
// writes L^T into R's and Linv^T into Rinv's diagonal block.
__device__ void diag_block(const float* a, int r, int base, float* R,
                           float* Rinv, CholSmem& sm) {
  const int tid = threadIdx.x;
  for (int e = tid; e < kCB * kCB; e += kCholThreads) {
    const int i = e / kCB, j = e % kCB;
    sm.Ab[i][j] = a[(long long)(base + i) * r + base + j];
    sm.L[i][j] = 0.f;
    sm.Li[i][j] = 0.f;
  }
  __syncthreads();
  for (int i = 0; i < kCB; ++i) {
    const float d = sqrtf(sm.Ab[i][i]);
    if (tid < kCB) sm.lv[tid] = tid >= i ? sm.Ab[tid][i] / d : 0.f;
    __syncthreads();
    for (int e = tid; e < kCB * kCB; e += kCholThreads) {
      const int p = e / kCB, q = e % kCB;
      sm.Ab[p][q] -= sm.lv[p] * sm.lv[q];
    }
    if (tid < kCB) sm.L[tid][i] = sm.lv[tid];
    __syncthreads();
    // Inverse row i (bordered form): (e_i - L[i, :i] Linv[:i, :]) / d.
    if (tid < kCB) {
      float prod = 0.f;
      for (int p = 0; p < i; ++p) prod = fmaf(sm.L[i][p], sm.Li[p][tid], prod);
      sm.Li[i][tid] = ((tid == i ? 1.f : 0.f) - prod) / d;
    }
    __syncthreads();
  }
  for (int e = tid; e < kCB * kCB; e += kCholThreads) {
    const int i = e / kCB, j = e % kCB;
    R[(long long)(base + i) * r + base + j] = sm.L[j][i];
    Rinv[(long long)(base + i) * r + base + j] = sm.Li[j][i];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kCholThreads)
chol_rinv_kernel(const float* G, float* R, float* Rinv, float* a, int r) {
  __shared__ CholSmem sm;
  const long long rr = (long long)r * r;
  for (long long e = threadIdx.x; e < rr; e += kCholThreads) {
    a[e] = G[e];
    R[e] = 0.f;
    Rinv[e] = 0.f;
  }
  __syncthreads();
  const int nb = r / kCB;
  for (int k = 0; k < nb; ++k) {
    const int base = k * kCB, rest = r - base - kCB;
    diag_block(a, r, base, R, Rinv, sm);
    if (rest > 0) {
      float* Rrow = R + (long long)base * r + base + kCB;
      // Rrow = Linv @ A[k, k+1:], Linv = (Rinv's diagonal block)^T.
      cta_mm<true>(kCB, rest, kCB, Rinv + (long long)base * r + base, r,
                   a + (long long)base * r + base + kCB, r, Rrow, r, MM_SET,
                   false, false, sm);
      cta_mm<true>(rest, rest, kCB, Rrow, r, Rrow, r,
                   a + (long long)(base + kCB) * r + base + kCB, r, MM_SUB,
                   true, false, sm);
    }
  }
  // The working copy is dead: its first 32 rows hold S = R[k, k+1:] @
  // Rinv[k+1:, k+1:] of each back-fill step.
  for (int k = nb - 2; k >= 0; --k) {
    const int kb = k * kCB, rest = r - kb - kCB;
    cta_mm<false>(kCB, rest, rest, R + (long long)kb * r + kb + kCB, r,
                  Rinv + (long long)(kb + kCB) * r + kb + kCB, r, a, r,
                  MM_SET, false, true, sm);
    cta_mm<false>(kCB, rest, kCB, Rinv + (long long)kb * r + kb, r, a, r,
                  Rinv + (long long)kb * r + kb + kCB, r, MM_NEG, false,
                  false, sm);
  }
}

}  // namespace mpbqr

extern "C" {

// G (r x r, fp32, row-major, read only) -> R and Rinv (r x r each), with
// r * r floats of global scratch; device pointers, one launch on `stream`.
// Returns the launch's CUDA error, or cudaErrorInvalidValue unless r is a
// positive multiple of 32.
int mpbqr_chol_rinv(const float* G, float* R, float* Rinv, float* scratch,
                    int r, void* stream) {
  if (r < 32 || r % 32 != 0) return (int)cudaErrorInvalidValue;
  mpbqr::chol_rinv_kernel<<<1, mpbqr::kCholThreads, 0,
                            (cudaStream_t)stream>>>(G, R, Rinv, scratch, r);
  return (int)cudaGetLastError();
}

}  // extern "C"
