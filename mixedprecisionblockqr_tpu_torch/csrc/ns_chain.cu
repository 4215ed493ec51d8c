// K1: the fused triangular Newton-Schulz inverse Cholesky of one SPD r x r
// Gram, as one kernel launch.
//
// Replaces mixedprecisionblockqr_tpu/ops/pallas/ns.py::ns_chain
// (_ns_chain_jit -> pl.pallas_call of _ns_kernel).
//
// What bounds it on this card: the latency of about three sequential r x r
// products per iteration, not operations or bytes (the whole chain reads
// and writes 3 r^2 floats).  The design (ns_chain.cuh) runs one chain on one
// thread-block cluster of R / 16 CTAs (R = 32, 64 or 128, the smallest that
// holds r) with every operand in (distributed) shared memory, the
// bf16-split products on the tensor cores and the fp32 ones as FMA spread
// over the cluster, so that a product costs a few microseconds and no
// launch, and nothing goes through global scratch; r > 128 runs on the
// L2 route (up to 16 CTAs, the operands in an L2-resident scratch).
#include "ns_chain.cuh"

extern "C" {

// G (r x r, fp32, row-major) -> X (r x r), t = triu(X^T G') (r x r) and
// resid = max|E| (one float; the exact final residual for `refine`
// chains).  All pointers are device pointers; the launch goes on `stream`;
// `scratch` holds the layout's scratch floats (the L2 route's operands).
// inst, route, ctas, scratch_floats, smem_bytes: ops/kernels/ns.py::
// ns_layout(r, ...).  Returns the launch's CUDA error
// (cudaErrorLaunchOutOfResources if the card cannot place one cluster), or
// cudaErrorInvalidValue for an r outside 1 .. kMaxWidth or a layout that
// differs from the kernel's.
int mpbqr_ns_chain(const float* G, float* X, float* t, float* resid,
                   float* scratch, int r, int iters, float shift, int refine,
                   int mid_iters, int omega, int fuse_xw, int inst, int route,
                   int ctas, int scratch_floats, int smem_bytes,
                   void* stream) {
  const mpbqr::KernelLayout lay{inst, route, ctas, scratch_floats,
                                smem_bytes};
  if (!mpbqr::chain_layout_ok(r, lay)) return (int)cudaErrorInvalidValue;
  cudaError_t err = mpbqr::launch_chain(
      r, lay, scratch, (cudaStream_t)stream, G, X, t, r, resid, iters,
      shift, refine, mid_iters, omega, fuse_xw, 1, mpbqr::RESID_RAW);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
