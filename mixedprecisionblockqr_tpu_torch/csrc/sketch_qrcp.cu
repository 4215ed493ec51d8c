// K7: greedy QRCP pivot selection on a small (d x w) sketch -- r classical
// Gram-Schmidt pivot steps in one kernel launch.
//
// Replaces mixedprecisionblockqr_tpu/ops/pallas/sketch.py::sketch_qrcp_ranks
// (_sketch_qrcp_ranks_padded -> pl.pallas_call of _sketch_qrcp_kernel).
//
// The TPU kernel keeps the whole sketch in VMEM (136 x 2048 fp32 = 1.1 MB
// at the RQRCP panels' first step), which no SM holds.  This first design
// is one CTA of 1024 threads that loops over the r steps: the column norms
// and the pivot column live in shared memory, the working copy of the
// sketch lives in global memory (L2-resident), and each thread owns whole
// columns, so that the row-major reads of neighbouring threads coalesce.
// The TPU kernel pads the width to a power of two to save compiles; this
// one takes the exact width and needs no padding.
// What bounds it: every step streams the working sketch through one SM
// twice (the coefficients, then the downdate) and writes it once, about
// 3.3 MB of L2 traffic per step at w = 2048; the r steps are strictly
// sequential.  Holding the sketch in the distributed shared memory of a
// thread-block cluster is the design for a later version.
//
// Per step s (the JAX kernel's semantics):
//   j     = first index of max(norms); a NaN max selects nothing;
//   qn    = q / ||q|| for the pivot column q (0 when ||q||^2 <= tiny);
//   coef  = qn^T work;  work -= qn coef;
//   norms = max(norms - coef^2, 0), the pivot and dead columns at -inf;
//   rank[j] = s.
// Products are fp32 FMA; the downdates round the product before the
// subtraction, as the plain version does.
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kSkThreads = 1024;
constexpr int kSkWarps = kSkThreads / 32;
// Dynamic shared memory the kernel may take: w + d floats.
constexpr int kSkMaxFloats = 200 * 1024 / 4;

__device__ __forceinline__ float nan_max0(float a) {
  // max(a, 0) that propagates NaN, as jnp.maximum (fmaxf drops NaN).
  return (a != a) ? a : fmaxf(a, 0.f);
}

// (value, index) of the first maximum; `nan` set when any value is NaN.
__device__ __forceinline__ void better(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__global__ void __launch_bounds__(kSkThreads)
sketch_qrcp_kernel(const float* __restrict__ B, float* __restrict__ work,
                   int* __restrict__ rank, int d, int w, int r) {
  extern __shared__ float smem[];
  float* norms = smem;     // w
  float* qn = smem + w;    // d
  __shared__ float red_v[kSkWarps];
  __shared__ int red_i[kSkWarps];
  __shared__ int red_nan[kSkWarps];
  __shared__ int s_j;
  __shared__ float s_scale;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int c = tid; c < w; c += kSkThreads) {
    float s = 0.f;
    for (int i = 0; i < d; ++i) {
      const float v = B[(long long)i * w + c];
      work[(long long)i * w + c] = v;
      s = fmaf(v, v, s);
    }
    norms[c] = s;
    rank[c] = w;
  }
  __syncthreads();

  for (int step = 0; step < r; ++step) {
    // 1. first-index argmax with jnp.max semantics.
    float bv = -INFINITY;
    int bi = INT_MAX, nan = 0;
    for (int c = tid; c < w; c += kSkThreads) {
      const float v = norms[c];
      if (v != v)
        nan = 1;
      else
        better(bv, bi, v, c);
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      better(bv, bi, ov, oi);
      nan |= __shfl_xor_sync(0xffffffffu, nan, o);
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
      red_nan[warp] = nan;
    }
    __syncthreads();
    if (tid == 0) {
      float v = red_v[0];
      int i = red_i[0], n = red_nan[0];
      for (int k = 1; k < kSkWarps; ++k) {
        better(v, i, red_v[k], red_i[k]);
        n |= red_nan[k];
      }
      s_j = (n || i == INT_MAX) ? -1 : i;
    }
    __syncthreads();
    const int j = s_j;

    // 2. the pivot column and its scale.
    for (int i = tid; i < d; i += kSkThreads)
      qn[i] = j >= 0 ? work[(long long)i * w + j] : 0.f;
    __syncthreads();
    if (warp == 0) {
      float s = 0.f;
      for (int i = lane; i < d; i += 32) s = fmaf(qn[i], qn[i], s);
      for (int o = 16; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0)
        s_scale = s > FLT_MIN ? 1.0f / sqrtf(fmaxf(s, FLT_MIN)) : 0.f;
    }
    __syncthreads();
    const float sc = s_scale;
    for (int i = tid; i < d; i += kSkThreads)
      qn[i] = sc != 0.f ? qn[i] * sc : 0.f;
    __syncthreads();

    // 3-5. coefficients, downdate, norms and rank, one column per thread.
    for (int c = tid; c < w; c += kSkThreads) {
      float cf = 0.f;
      for (int i = 0; i < d; ++i)
        cf = fmaf(qn[i], work[(long long)i * w + c], cf);
      for (int i = 0; i < d; ++i) {
        float* p = work + (long long)i * w + c;
        *p = __fsub_rn(*p, __fmul_rn(qn[i], cf));
      }
      const float nv = norms[c];
      const bool dead = c == j || nv == -INFINITY;
      norms[c] = dead ? -INFINITY : nan_max0(__fsub_rn(nv, __fmul_rn(cf, cf)));
      if (c == j) rank[c] = step;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Largest d + w the kernel takes (its dynamic shared memory).
int mpbqr_sketch_qrcp_max_floats() { return kSkMaxFloats; }

// B (d x w, fp32, row-major, read only) -> rank (w, int32): the s-th pivot
// holds s, unselected columns hold w.  work (d x w floats) is scratch.  All
// device pointers; the launch goes on `stream`.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for shapes it does not take.
int mpbqr_sketch_qrcp(const float* B, float* work, int* rank, int d, int w,
                      int r, void* stream) {
  if (d < 1 || r < 1 || r > w || d + w > kSkMaxFloats)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)w + d);
  cudaError_t err = cudaFuncSetAttribute(
      sketch_qrcp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sketch_qrcp_kernel<<<1, kSkThreads, smem, (cudaStream_t)stream>>>(
      B, work, rank, d, w, r);
  return (int)cudaGetLastError();
}

}  // extern "C"
