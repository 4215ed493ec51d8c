// K2: one whole Block Gram-Schmidt group -- g sequential panel
// factorizations (Gram, NS chain, Q = P X, t) plus the eager in-group
// projections C -= Qk (Qk^T C), with the shifted three-pass chain on
// robust tail panels.
// K5: the same group with the inter-group projection on entry: the raw
// columns are scrubbed against all previous Q (C2 = Qprev^T P,
// P -= Qprev C2) before the group body runs.
//
// Replaces mixedprecisionblockqr_tpu/ops/pallas/ns.py::bgs_group_fused
// (_bgs_group_fused_jit -> pl.pallas_call of _bgs_group_kernel) and
// ::bgs_group_fused_proj (_bgs_group_fused_proj_jit -> pl.pallas_call of
// _bgs_group_proj_kernel); both share _group_loop, _tri_ns_panel and
// _robust_spill there, and group_body here.
//
// The TPU kernel keeps the whole m x g*r group (8 MB at the 2048 x 1024
// headline) and the 4 MB Rg in VMEM.  No SM holds that, so this port is one
// C entry point that issues, on the caller's stream, a fixed sequence of
// kernels per panel j:
//   * the tall Gram P^T P, split over m into 256-row chunks, with a
//     deterministic second-pass reduction (no atomics);
//   * the device NS chain of ns_chain.cuh (one thread-block cluster);
//   * Q = P X into a scratch panel, then copied into the panel's slot;
//   * t = triu(X^T G) straight into Rg's diagonal block;
//   * the eager projection pair G1 = Qk^T C (written to Rg's row block) and
//     C -= Qk G1, in place over the group's remaining columns;
//   * for robust panels, the three-pass chain of
//     _tri_ns_panel(robust=True), spilling Q1 / Q2 through scratch panels.
// What bounds it: at g*r <= 1024 the tall products are memory-bound
// (each reads the m x r panel and the m x c trailing block once per
// panel), and the r x r chains are latency-bound on one cluster.  The simple
// tiled fp32-FMA GEMM of panel.cuh (64 x 64 tiles, bf16 rounding on load
// when asked) keeps every product inside this repository's sources, as
// the TPU kernel computes them in its own body.  Fusing the sequence into
// one persistent or cluster kernel with wgmma and TMA is later work.
// K5's scrub adds two products over the m x p prefix of previous Q, which
// is read twice (p grows to n - g r): at p = w = 1024, m = 2048 they are
// 8.6 GFLOP of fp32 FMA, more than twice the group body's projections.
#include "panel.cuh"

namespace mpbqr {

// worst = max(0, resid[0], ..., resid[g-1]), NaN-propagating.
__global__ void worst_resid(const float* resid, int g, float* worst) {
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    float w = 0.f;
    for (int j = 0; j < g; ++j) w = nan_max(w, resid[j]);
    *worst = w;
  }
}

struct GroupScratch {
  float *comb, *G, *X1, *X2, *X3, *T1, *T2, *T3, *tmpA, *tmpB, *resid,
      *part;
};

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
  take(&d->comb, 2 * rr);
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

// The group body on Q (m x g*r, already scrubbed against previous groups,
// factored in place): per panel the Gram, the chain(s), Q = P X, t into
// Rg's diagonal block and the eager projection of the later columns; then
// the worst residual.  Rg must be zeroed by the caller.  Returns the first
// CUDA error met.
static int group_body(cudaStream_t st, float* Q, float* Rg, float* worst,
                      const GroupScratch& s, int m, int r, int g,
                      const int* iters, const int* robust, bool bd, bool bg,
                      bool chain_mid) {
  const int w = g * r;
  auto mid = [&](int it) {
    return chain_mid ? std::max(0, it - kMidFinal) : 0;
  };
  cudaError_t err;
  for (int j = 0; j < g; ++j) {
    const int c0 = j * r;
    float* Pj = Q + c0;
    float* Rjj = Rg + (size_t)c0 * w + c0;
    gemm(st, true, bg, r, r, m, Pj, w, Pj, w, s.G, r, false, s.part);
    if (!robust[j]) {
      err = launch_chain(r, st, s.G, s.X1, Rjj, w, s.resid + j, iters[j],
                         0.f, 0, mid(iters[j]), 1, 1, 1, RESID_SQUARE);
      if (err != cudaSuccess) return (int)err;
      gemm(st, false, bg, m, r, r, Pj, w, s.X1, r, s.tmpA, r, false, s.part);
      err = cudaMemcpy2DAsync(Pj, sizeof(float) * w, s.tmpA,
                              sizeof(float) * r, sizeof(float) * r, m,
                              cudaMemcpyDeviceToDevice, st);
      if (err != cudaSuccess) return (int)err;
    } else {
      // Pass 1: shifted Gram (condition capped), t1 = X1^T Gs in full.
      err = launch_chain(r, st, s.G, s.X1, s.T1, r, s.resid + j,
                         kRobustIt1, 1e-3f, 0, mid(kRobustIt1), 0, 1, 0,
                         RESID_RAW);
      if (err != cudaSuccess) return (int)err;
      gemm(st, false, bg, m, r, r, Pj, w, s.X1, r, s.tmpA, r, false, s.part);
      gemm(st, true, bg, r, r, m, s.tmpA, r, s.tmpA, r, s.G, r, false,
           s.part);
      // Pass 2 on the fresh Gram of Q1, t2 = X2^T M1 in full.
      err = launch_chain(r, st, s.G, s.X2, s.T2, r, s.resid + j,
                         kRobustIt2, 0.f, 0, mid(kRobustIt2), 0, 1, 0,
                         RESID_RAW);
      if (err != cudaSuccess) return (int)err;
      gemm(st, false, bg, m, r, r, s.tmpA, r, s.X2, r, s.tmpB, r, false,
           s.part);
      gemm(st, true, bg, r, r, m, s.tmpB, r, s.tmpB, r, s.G, r, false,
           s.part);
      // Pass 3: identity-seeded refine with the exact final residual.
      err = launch_chain(r, st, s.G, s.X3, s.T3, r, s.resid + j,
                         kRobustIt3, 0.f, 1, 0, 1, 1, 0, RESID_SCALE);
      if (err != cudaSuccess) return (int)err;
      gemm(st, false, bg, m, r, r, s.tmpB, r, s.X3, r, Pj, w, false, s.part);
      launch_combine(r, st, s.T1, s.T2, s.T3, Rjj, w, s.comb);
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
  cudaError_t err;
  if (Q != P) {
    err = cudaMemcpyAsync(Q, P, sizeof(float) * (size_t)m * w,
                          cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaMemsetAsync(Rg, 0, sizeof(float) * (size_t)w * w, st);
  if (err != cudaSuccess) return (int)err;
  return group_body(st, Q, Rg, worst, s, m, r, g, iters, robust,
                    bf16_dots != 0, bf16_gram != 0, chain_mid != 0);
}

// K5.  P (m x g*r, fp32, raw columns, read only) and Qprev (m x p, leading
// dimension ldq, fp32 or bf16 per qprev_bf16: the strided prefix of the
// driver's Q buffer is read in place, bf16 widened on load) -> Q (m x g*r),
// Rprev (p x g*r) = Qprev^T P, Rg and *worst as in mpbqr_bgs_group.
// The scrub is block-classical: all of C2 comes from the raw P, then one
// subtracting product Q -= Qprev C2 in place on the group buffer.  The
// transposed product runs split-K through the same `part` scratch as the
// group body (sized for an r-row output), so Qprev's columns are taken r
// at a time, each block's rows going straight into Rprev.  With bf16_dots
// both products round their operands to bf16 on load (the second one
// rounds C2 as it reads it); Rprev keeps the unrounded fp32 C2.
int mpbqr_bgs_group_proj(const float* P, const void* Qprev, int ldq,
                         int qprev_bf16, int p, float* Q, float* Rprev,
                         float* Rg, float* worst, float* scratch, int m,
                         int r, int g, const int* iters, const int* robust,
                         int bf16_dots, int bf16_gram, int chain_mid,
                         void* stream) {
  using namespace mpbqr;
  if (r != 32 && r != 64 && r != 128) return (int)cudaErrorInvalidValue;
  if (p < 1 || ldq < p) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int w = g * r;
  GroupScratch s;
  group_scratch_floats(m, r, g, &s, scratch);
  cudaError_t err = cudaMemcpyAsync(Q, P, sizeof(float) * (size_t)m * w,
                                    cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(Rg, 0, sizeof(float) * (size_t)w * w, st);
  if (err != cudaSuccess) return (int)err;
  const bool bd = bf16_dots != 0;
  auto scrub = [&](auto* Qp) {
    for (int b0 = 0; b0 < p; b0 += r)
      gemm(st, true, bd, std::min(r, p - b0), w, m, Qp + b0, ldq, Q, w,
           Rprev + (size_t)b0 * w, w, false, s.part);
    gemm(st, false, bd, m, w, p, Qp, ldq, Rprev, w, Q, w, true, s.part);
  };
  if (qprev_bf16)
    scrub(static_cast<const __nv_bfloat16*>(Qprev));
  else
    scrub(static_cast<const float*>(Qprev));
  return group_body(st, Q, Rg, worst, s, m, r, g, iters, robust, bd,
                    bf16_gram != 0, chain_mid != 0);
}

}  // extern "C"
