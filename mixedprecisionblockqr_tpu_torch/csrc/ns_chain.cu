// K1: the fused triangular Newton-Schulz inverse Cholesky of one SPD r x r
// Gram, as one kernel launch.
//
// Replaces mixedprecisionblockqr_tpu/ops/pallas/ns.py::ns_chain
// (_ns_chain_jit -> pl.pallas_call of _ns_kernel).  Bound on this card:
// latency of ~3 sequential r x r products per iteration; the design runs
// the whole chain in one CTA with L2-resident scratch so that no product
// pays a launch (see ns_chain.cuh).
#include "ns_chain.cuh"

extern "C" {

// Floats of global scratch that mpbqr_ns_chain needs for an r x r Gram.
long long mpbqr_ns_chain_scratch_floats(int r) { return 5LL * r * r; }

// G (r x r, fp32, row-major) -> X (r x r), t = triu(X^T G') (r x r) and
// resid = max|E| (one float; the exact final residual for `refine`
// chains).  All pointers are device pointers; the
// launch goes on `stream`.  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for an r the kernel does not take.
int mpbqr_ns_chain(const float* G, float* X, float* t, float* resid,
                   float* scratch, int r, int iters, float shift, int refine,
                   int mid_iters, int omega, int fuse_xw, void* stream) {
  if (!mpbqr::launch_chain(r, (cudaStream_t)stream, G, X, t, r, resid,
                           scratch, iters, shift, refine, mid_iters, omega,
                           fuse_xw, 1, mpbqr::RESID_RAW))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
