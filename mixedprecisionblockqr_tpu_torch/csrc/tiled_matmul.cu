// K8: C = A @ B for any (m, k) x (k, n), in the four type combinations of
// the reference: f32 x f32 -> f32 (true fp32), bf16 x bf16 -> f32,
// bf16 x bf16 -> bf16 (fp32 accumulator, one rounding at the end) and
// s8 x s8 -> s32 (exact).
//
// Replaces mixedprecisionblockqr_tpu/ops/pallas/gemm.py::tiled_matmul
// (pl.pallas_call of _gemm_kernel).
//
// The TPU kernel walks a (M/bm, N/bn, K/bk) grid in order and carries the
// accumulator tile in VMEM scratch across the K steps; its wrapper pads the
// operands to tile multiples because BlockSpec needs whole blocks.  Here
// each CTA owns one 128 x 128 output tile and loops over K itself, the
// accumulator lives in registers (8 x 8 per thread, 256 threads), and the
// ragged edges are predicated loads and stores: no padded copies.
// What bounds it: operations.  This first kernel multiplies on the FMA /
// integer units (operands widened to fp32 or s32 in shared memory, read
// back as 16-byte vectors), so bf16 and s8 run at the fp32 / s32 scalar
// rate, far below the tensor cores' bound; bf16 x bf16 products are exact
// in fp32, so only the order of the fp32 sum differs from a tensor-core
// product.  TF32 is never used.  wgmma fed by TMA is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mpbqr {

constexpr int kTM = 128, kTN = 128, kTK = 16;
constexpr int kMmThreads = 256;

template <typename T>
struct alignas(16) Vec4 {
  T v[4];
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ int widen(int8_t x) { return (int)x; }

__device__ __forceinline__ void narrow(float acc, float* out) { *out = acc; }
__device__ __forceinline__ void narrow(float acc, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(acc);
}
__device__ __forceinline__ void narrow(int acc, int* out) { *out = acc; }

__device__ __forceinline__ float mul_add(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ int mul_add(int a, int b, int c) {
  return a * b + c;
}

// TIn: operand type in memory; TAcc: float or int, the shared-memory and
// accumulator type; TOut: the output type.  Thread (ty, tx) of the 16 x 16
// layout owns rows {4 ty .. 4 ty + 3} and {64 + 4 ty ..}, columns likewise.
template <typename TIn, typename TAcc, typename TOut>
__global__ void __launch_bounds__(kMmThreads)
tiled_matmul_kernel(int M, int N, int K, const TIn* A, int lda, const TIn* B,
                    int ldb, TOut* C, int ldc) {
  // As is stored transposed (k-major): the 4-word row pad spreads those
  // stores over the banks and keeps each row 16-byte aligned.
  __shared__ __align__(16) TAcc As[kTK][kTM + 4];
  __shared__ __align__(16) TAcc Bs[kTK][kTN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int i0 = blockIdx.y * kTM, j0 = blockIdx.x * kTN;
  TAcc acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = (TAcc)0;

  for (int k0 = 0; k0 < K; k0 += kTK) {
#pragma unroll
    for (int q = 0; q < (kTM * kTK) / kMmThreads; ++q) {
      const int e = threadIdx.x + q * kMmThreads;
      const int i = e / kTK, k = e % kTK;  // A: contiguous along k
      TAcc v = (TAcc)0;
      if (i0 + i < M && k0 + k < K)
        v = widen(A[(long long)(i0 + i) * lda + k0 + k]);
      As[k][i] = v;
      const int kk = e / kTN, j = e % kTN;  // B: contiguous along j
      TAcc w = (TAcc)0;
      if (j0 + j < N && k0 + kk < K)
        w = widen(B[(long long)(k0 + kk) * ldb + j0 + j]);
      Bs[kk][j] = w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTK; ++k) {
      TAcc ra[8], rb[8];
      const Vec4<TAcc> a0 =
          *reinterpret_cast<const Vec4<TAcc>*>(&As[k][4 * ty]);
      const Vec4<TAcc> a1 =
          *reinterpret_cast<const Vec4<TAcc>*>(&As[k][64 + 4 * ty]);
      const Vec4<TAcc> b0 =
          *reinterpret_cast<const Vec4<TAcc>*>(&Bs[k][4 * tx]);
      const Vec4<TAcc> b1 =
          *reinterpret_cast<const Vec4<TAcc>*>(&Bs[k][64 + 4 * tx]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ra[c] = a0.v[c];
        ra[4 + c] = a1.v[c];
        rb[c] = b0.v[c];
        rb[4 + c] = b1.v[c];
      }
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b)
          acc[a][b] = mul_add(ra[a], rb[b], acc[a][b]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = i0 + (a < 4 ? 4 * ty + a : 64 + 4 * ty + a - 4);
    if (i >= M) continue;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = j0 + (b < 4 ? 4 * tx + b : 64 + 4 * tx + b - 4);
      if (j >= N) continue;
      narrow(acc[a][b], C + (long long)i * ldc + j);
    }
  }
}

template <typename TIn, typename TAcc, typename TOut>
static int launch_mm(cudaStream_t st, int M, int N, int K, const void* A,
                     int lda, const void* B, int ldb, void* C, int ldc) {
  const dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  tiled_matmul_kernel<TIn, TAcc, TOut><<<grid, kMmThreads, 0, st>>>(
      M, N, K, static_cast<const TIn*>(A), lda, static_cast<const TIn*>(B),
      ldb, static_cast<TOut*>(C), ldc);
  return (int)cudaGetLastError();
}

}  // namespace mpbqr

extern "C" {

// C (m x n) = A (m x k) @ B (k x n), row-major with leading dimensions
// lda / ldb / ldc in elements, device pointers.  combo: 0 = f32 -> f32,
// 1 = bf16 -> f32, 2 = bf16 -> bf16, 3 = s8 -> s32.  k == 0 gives zeros.
// Returns the launch's CUDA error, or cudaErrorInvalidValue for an unknown
// combo or an empty output.
int mpbqr_tiled_matmul(const void* A, const void* B, void* C, int m, int n,
                       int k, int lda, int ldb, int ldc, int combo,
                       void* stream) {
  using namespace mpbqr;
  if (m < 1 || n < 1 || k < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (combo) {
    case 0:
      return launch_mm<float, float, float>(st, m, n, k, A, lda, B, ldb, C,
                                            ldc);
    case 1:
      return launch_mm<__nv_bfloat16, float, float>(st, m, n, k, A, lda, B,
                                                    ldb, C, ldc);
    case 2:
      return launch_mm<__nv_bfloat16, float, __nv_bfloat16>(
          st, m, n, k, A, lda, B, ldb, C, ldc);
    case 3:
      return launch_mm<int8_t, int, int>(st, m, n, k, A, lda, B, ldb, C, ldc);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
