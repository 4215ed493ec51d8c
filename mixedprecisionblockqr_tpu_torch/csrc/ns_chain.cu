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
// Under jax.vmap the TPU kernel takes the batch as a grid axis; here the
// batched entry runs one cluster a member in one launch.
#include "ns_chain.cuh"

extern "C" {

#ifdef MPBQR_NS_PROF
// Copy the phase clocks of the last launch of each route to the host:
// the shared-memory route's (8 CTAs x {launch, iterations} x NSP_SLOTS
// signed 64-bit; ns_chain.cuh) into `prof`, the L2 route's (16 CTAs x
// {launch, iterations} x NSL_SLOTS) into `l2`.
int mpbqr_ns_prof(long long* prof, long long* l2) {
  cudaError_t err = cudaMemcpyFromSymbol(prof, mpbqr::g_ns_prof,
                                         sizeof(mpbqr::g_ns_prof));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(l2, mpbqr::g_ns_l2_prof,
                                   sizeof(mpbqr::g_ns_l2_prof));
}
#endif

// The batched K1: B chains of one width and one set of options in ONE
// launch of B clusters (grid (ctas, B), blockIdx.y the member).  G, X and
// t are B x r x r contiguous (member b at b r^2 floats), resid B floats,
// and `scratch` holds B x scratch_floats (one L2-route scratch a member;
// none on the shared-memory route).  Member b's outputs are bit for bit
// those of mpbqr_ns_chain on its Gram.  The other arguments as
// mpbqr_ns_chain takes them.  Returns cudaErrorInvalidValue for a B
// outside 1 .. 65535, else as mpbqr_ns_chain.
int mpbqr_ns_chain_batched(const float* G, float* X, float* t, float* resid,
                           float* scratch, int B, int r, int iters,
                           float shift, int refine, int mid_iters, int omega,
                           int fuse_xw, int inst, int route, int ctas,
                           int scratch_floats, int smem_bytes, void* stream) {
  using namespace mpbqr;
  const KernelLayout lay{inst, route, ctas, scratch_floats, smem_bytes};
  if (!chain_layout_ok(r, lay) || B < 1 || B > kMaxBatch)
    return (int)cudaErrorInvalidValue;
  const long long rr = (long long)r * r;
  cudaError_t err = launch_chain(
      r, lay, scratch, (cudaStream_t)stream, G, X, t, r, resid, iters, shift,
      refine, mid_iters, omega, fuse_xw, 1, RESID_RAW, B,
      ChainBatch{rr, rr, rr, 1, scratch_floats});
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// G (r x r, fp32, row-major) -> X (r x r), t = triu(X^T G') (r x r) and
// resid = max|E| (one float; the exact final residual for `refine`
// chains).  All pointers are device pointers; the launch goes on `stream`;
// `scratch` holds the layout's scratch floats (the L2 route's operands).
// inst, route, ctas, scratch_floats, smem_bytes: ops/kernels/ns.py::
// ns_layout(r, ...).  Returns the launch's CUDA error
// (cudaErrorLaunchOutOfResources if the card cannot place one cluster), or
// cudaErrorInvalidValue for an r outside 1 .. kMaxWidth or a layout that
// differs from the kernel's.  The batched entry's B = 1.
int mpbqr_ns_chain(const float* G, float* X, float* t, float* resid,
                   float* scratch, int r, int iters, float shift, int refine,
                   int mid_iters, int omega, int fuse_xw, int inst, int route,
                   int ctas, int scratch_floats, int smem_bytes,
                   void* stream) {
  return mpbqr_ns_chain_batched(G, X, t, resid, scratch, 1, r, iters, shift,
                                refine, mid_iters, omega, fuse_xw, inst,
                                route, ctas, scratch_floats, smem_bytes,
                                stream);
}

// How many K1 clusters of the layout (ns_layout(r, ...)) the card keeps
// resident at once, in *out: a batch of B runs in ceil(B / *out) waves.
// Returns cudaErrorInvalidValue for a layout the kernel does not run,
// else the CUDA error of the query.
int mpbqr_ns_chain_resident(int r, int inst, int route, int ctas,
                            int scratch_floats, int smem_bytes, int* out) {
  using namespace mpbqr;
  const KernelLayout lay{inst, route, ctas, scratch_floats, smem_bytes};
  *out = 0;
  if (!chain_layout_ok(r, lay)) return (int)cudaErrorInvalidValue;
  return (int)chain_resident(r, lay, out);
}

}  // extern "C"
