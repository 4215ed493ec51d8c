// K3: one whole panel factorization -- the fp32 Gram, the triangular NS
// chain(s), Q = P X and the R block t -- with the shifted three-pass chain
// when `robust`.
//
// Replaces mixedprecisionblockqr_tpu/ops/pallas/ns.py::panel_qr_fused
// (_panel_qr_fused_jit -> pl.pallas_call of _panel_qr_kernel).
//
// The TPU kernel holds the whole m x r panel and its intermediates in VMEM;
// at the RQRCP panels' 4096 x 128 the panel alone is 2 MB, far beyond one
// SM's 227 KB.  So this is one C entry point that issues a fixed kernel
// sequence on the caller's stream, built from the pieces K2 uses
// (panel.cuh): the Gram as one gemm_tn launch whose K is split over the
// CTAs of thread-block clusters, the cluster chain of ns_chain.cuh, the
// tall Q = P X products (gemm_nt, a CTA owning whole rows) into scratch
// panels (L2-resident at these sizes), and the triangular combine of the
// robust R block (panel.cuh's combine_kernel: r / 16 CTAs, both of its
// r x r products in shared memory; above 128 combine_l2_kernel: blocks
// of 32 x 16, a cluster a column block).  Every product is true fp32 FMA (the reference's
// Precision.HIGHEST for this kernel); the layout is ops/kernels/ns.py::
// group_layout(m, r)'s.  Its chains are serial, so it has no look-ahead.
// What bounds it: the r x r chains are latency-bound on one cluster (26 + 4
// sequential iterations in robust mode); the tall products read the m x r
// panel once each and fill the card with ~128-CTA grids.
//
// Residual convention (unlike K2, which squares or scales inside): resid
// is the raw max|E| of the last chain -- one step behind in plain mode,
// the exact final residual of the refine pass in robust mode.
#include "panel.cuh"

namespace mpbqr {

struct PanelScratch {
  float *G, *X1, *X2, *X3, *T1, *T2, *T3, *tmpA, *tmpB, *chain, *comb;
};

static long long panel_scratch_floats(int m, int r, PanelScratch* s,
                                      float* base) {
  const long long rr = (long long)r * r, mr = (long long)m * r;
  long long off = 0;
  auto take = [&](float** p, long long n) {
    if (s) *p = base + off;
    off += n;
  };
  PanelScratch dummy;
  PanelScratch* d = s ? s : &dummy;
  take(&d->G, rr);
  take(&d->X1, rr);
  take(&d->X2, rr);
  take(&d->X3, rr);
  take(&d->T1, rr);
  take(&d->T2, rr);
  take(&d->T3, rr);
  take(&d->tmpA, mr);
  take(&d->tmpB, mr);
  // The L2 kernels' tensor maps start on 16 bytes: the chain's scratch
  // here, and the combine's after it (the chain's is whole 16-byte
  // pieces).
  off = (off + 3) / 4 * 4;
  take(&d->chain, chain_inst(r) ? 0 : chain_l2_scratch_floats(r));
  take(&d->comb, combine_scratch_floats(r));
  return off;
}

}  // namespace mpbqr

extern "C" {

// Floats of global scratch that mpbqr_panel_qr needs for an m x r panel.
long long mpbqr_panel_qr_scratch_floats(int m, int r) {
  return mpbqr::panel_scratch_floats(m, r, nullptr, nullptr);
}

// P (m x r, fp32, row-major, read only) -> Q (m x r), t (r x r, upper) and
// *resid (one float), all device pointers; the launches go on `stream`.
// Plain mode runs `iters` iterations; robust mode the fixed three-pass
// schedule.  chain_mid runs all but the final kMidFinal iterations of each
// non-refine chain with bf16-split products.  split, chunk, bm_panel,
// bm_wide, bn and the chain's inst, route, ctas, scratch_floats,
// smem_bytes: the layout of ops/kernels/ns.py::group_layout(m, r, ...).
// Q = P X is never in place here, so any r runs gemm_nt's column blocks.
// Returns the first CUDA error met, or cudaErrorInvalidValue for an r
// outside 1 .. kMaxWidth or a layout the products or the chain do not run.
int mpbqr_panel_qr(const float* P, float* Q, float* t, float* resid,
                   float* scratch, int m, int r, int iters, int robust,
                   int chain_mid, int split, int chunk, int bm_panel,
                   int bm_wide, int bn, int inst, int route, int ctas,
                   int chain_scratch, int chain_smem, void* stream) {
  using namespace mpbqr;
  const ProductLayout lay{split, chunk, bm_panel, bm_wide, bn};
  const KernelLayout cl{inst, route, ctas, chain_scratch, chain_smem};
  if (!product_layout_ok(m, r, lay) || !chain_layout_ok(r, cl))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  PanelScratch s;
  panel_scratch_floats(m, r, &s, scratch);
  auto mid = [&](int it) {
    return chain_mid ? std::max(0, it - kMidFinal) : 0;
  };
  auto gram = [&](const float* A, float* G) {
    return tn(st, false, r, r, m, A, r, A, r, G, r, lay.split, lay.chunk);
  };
  auto qprod = [&](const float* A, const float* X, float* Qo) {
    return nt(st, false, m, r, r, A, r, X, r, Qo, r, false, lay.bm_panel,
              lay.bn);
  };
  auto chain = [&](float* X, float* tt, int it, float shift, int refine,
                   int mid_it, int omega, int triu_t) {
    return launch_chain(r, cl, s.chain, st, s.G, X, tt, r, resid, it, shift,
                        refine, mid_it, omega, 1, triu_t, RESID_RAW);
  };
  cudaError_t err = gram(P, s.G);
  if (err != cudaSuccess) return (int)err;
  if (!robust) {
    err = chain(s.X1, t, iters, 0.f, 0, mid(iters), 1, 1);
    if (err != cudaSuccess) return (int)err;
    return (int)qprod(P, s.X1, Q);
  }
  // Pass 1: shifted Gram (condition capped), t1 = X1^T Gs in full.
  err = chain(s.X1, s.T1, kRobustIt1, 1e-3f, 0, mid(kRobustIt1), 0, 0);
  if (err == cudaSuccess) err = qprod(P, s.X1, s.tmpA);
  if (err == cudaSuccess) err = gram(s.tmpA, s.G);
  // Pass 2 on the fresh Gram of Q1, t2 = X2^T M1 in full.
  if (err == cudaSuccess)
    err = chain(s.X2, s.T2, kRobustIt2, 0.f, 0, mid(kRobustIt2), 0, 0);
  if (err == cudaSuccess) err = qprod(s.tmpA, s.X2, s.tmpB);
  if (err == cudaSuccess) err = gram(s.tmpB, s.G);
  // Pass 3: identity-seeded refine with the exact final residual.
  if (err == cudaSuccess) err = chain(s.X3, s.T3, kRobustIt3, 0.f, 1, 0, 1, 0);
  if (err == cudaSuccess) err = qprod(s.tmpB, s.X3, Q);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_combine(r, combine_layout(r, cl.ctas), st, s.T1, s.T2,
                             s.T3, t, r, s.comb);
}

// out = triu(T3 @ (T2 @ T1)) (r x r each, fp32, row-major; out with
// leading dimension ldo), device pointers, launched on `stream`: the
// combine that closes a robust panel of K2 and K3, on its own; `scratch`
// holds the layout's scratch floats (16-byte aligned).  inst, route,
// ctas, scratch_floats, smem_bytes: ops/kernels/ns.py::combine_layout(r,
// ...).  Returns the launch's error, or cudaErrorInvalidValue for an r
// outside 1 .. kMaxWidth or a layout that differs from the kernel's.
int mpbqr_tri_combine(const float* T1, const float* T2, const float* T3,
                      float* out, float* scratch, int r, int ldo, int inst,
                      int route, int ctas, int scratch_floats,
                      int smem_bytes, void* stream) {
  using namespace mpbqr;
  const KernelLayout lay{inst, route, ctas, scratch_floats, smem_bytes};
  if (!combine_layout_ok(r, lay)) return (int)cudaErrorInvalidValue;
  return (int)launch_combine(r, lay, (cudaStream_t)stream, T1, T2, T3, out,
                             ldo, scratch);
}

}  // extern "C"
