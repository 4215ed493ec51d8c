// K4: the general Newton-Schulz inverse of the r x r Yamamoto S, as one
// kernel launch:
//   X0 = (2/3) I;  `iters` times X <- X (2I - S X);  resid = max|I - S X|
// of the final iterate, all in true fp32.
//
// Replaces mixedprecisionblockqr_tpu/ops/pallas/ns.py::ninv_chain
// (pl.pallas_call of _ninv_kernel).  On the TPU S, X and S X sit in VMEM;
// on Hopper the three 64 KB operands at r = 128 do not fit one SM's shared
// memory, so one CTA of 256 threads runs the whole chain with its operands
// in L2-resident global scratch, each r x r product streaming 16-deep
// k-slices through shared memory (blk_mm of ns_chain.cuh).
// What bounds it: 2 * iters + 1 strictly sequential r x r products, so it
// is latency-bound on one SM (about 25 products of 2 MFMA each at 12
// iterations), not FLOP- or byte-bound; spreading the products over a
// thread-block cluster, as K1's chain does, is later work.
#include "ns_chain.cuh"

namespace mpbqr {

// Scratch: 3 r x r floats (two ping-pong iterates and the product S X).
template <int R>
__global__ void __launch_bounds__(kChainThreads)
ninv_kernel(const float* S, float* X, float* resid, float* scr, int iters) {
  __shared__ ChainSmem<R> sm;
  float* cur = scr;
  float* nxt = scr + R * R;
  float* Tm = scr + 2 * R * R;
  for (int e = threadIdx.x; e < R * R; e += kChainThreads)
    cur[e] = (e / R == e % R) ? (2.0f / 3.0f) : 0.f;
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    blk_mm<R>(Tm, S, false, cur, sm);  // S X
    for (int e = threadIdx.x; e < R * R; e += kChainThreads)
      Tm[e] = ((e / R == e % R) ? 2.f : 0.f) - Tm[e];
    __syncthreads();
    blk_mm<R>(nxt, cur, false, Tm, sm);  // X (2I - S X)
    float* sw = cur;
    cur = nxt;
    nxt = sw;
  }
  blk_mm<R>(Tm, S, false, cur, sm);
  float m = 0.f;
  for (int e = threadIdx.x; e < R * R; e += kChainThreads) {
    X[e] = cur[e];
    m = nan_max(m, fabsf(((e / R == e % R) ? 1.f : 0.f) - Tm[e]));
  }
  m = blk_max(m, sm.red);
  if (threadIdx.x == 0) *resid = m;
}

}  // namespace mpbqr

extern "C" {

// Floats of global scratch that mpbqr_ninv_chain needs for an r x r S.
long long mpbqr_ninv_chain_scratch_floats(int r) { return 3LL * r * r; }

// S (r x r, fp32, row-major) -> X (r x r) and *resid (one float), device
// pointers, launched on `stream`.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an r the kernel does not take.
int mpbqr_ninv_chain(const float* S, float* X, float* resid, float* scratch,
                     int r, int iters, void* stream) {
  using namespace mpbqr;
  cudaStream_t st = (cudaStream_t)stream;
  switch (r) {
    case 32: ninv_kernel<32><<<1, kChainThreads, 0, st>>>(S, X, resid, scratch, iters); break;
    case 64: ninv_kernel<64><<<1, kChainThreads, 0, st>>>(S, X, resid, scratch, iters); break;
    case 128: ninv_kernel<128><<<1, kChainThreads, 0, st>>>(S, X, resid, scratch, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
