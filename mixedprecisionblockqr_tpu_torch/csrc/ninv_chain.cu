// K4: the general Newton-Schulz inverse of the r x r Yamamoto S, as one
// kernel launch:
//   X0 = (2/3) I;  `iters` times X <- X (2I - S X);  resid = max|I - S X|
// of the final iterate, all in true fp32 FMA (never TF32, never a bf16
// split: the reference's Precision.HIGHEST).
//
// Replaces mixedprecisionblockqr_tpu/ops/pallas/ns.py::ninv_chain
// (pl.pallas_call of _ninv_kernel).  On the TPU S, X and S X sit in VMEM.
//
// What bounds it on this card: 2 * iters + 1 strictly sequential r x r
// products (2 r^3 operations each, 4.2 MFLOP at r = 128), far too small to
// fill the card, and an exchange of X between them: each iteration costs
// two products bound by shared-memory bandwidth and one all-gather bound by
// the cluster's network (utils/ninv_probe.py --phases).  The design
// spreads each product over a cluster and keeps everything on chip:
//   * One thread-block cluster of r / 16 CTAs (8 at r = 128); CTA p owns
//     the 16 columns 16 p .. 16 p + 15 of X and of E = 2I - S X.
//   * S is constant: every CTA loads it once into shared memory (cp.async)
//     and keeps it for the whole chain.  X is replicated the same way, in
//     two buffers, and the CTA's own columns of X and E are kept beside it,
//     transposed, so that both products of an iteration have ns_chain.cuh's
//     form D[p][q] = <P[p, :], Q[q, :]> with P replicated:
//       E[:, own] = 2I - S X[:, own]     (P = S,  Q = own columns of X)
//       X[:, own] <- X E[:, own]         (P = X,  Q = own columns of E)
//     Both are local general products (prod_gen: 4 x 4 tiles a thread, k
//     split over the two halves of the block; shared-memory bound).
//   * One exchange an iteration: each owner writes its 16 new columns into
//     every CTA's other X buffer over distributed shared memory (16-byte
//     stores), then arrives at the cluster barrier, and waits on it only
//     before the next X E: the next S X needs only the own columns, so it
//     runs while the exchange drains.  With two buffers no CTA can still be
//     reading the buffer being written (every CTA had read it before it
//     arrived at the previous barrier, which this CTA has waited on), so
//     one barrier an iteration suffices.  The last iteration sends nothing:
//     the residual needs only the own columns.  Nothing goes through global
//     scratch.
// The residual max|I - S X| is reduced with nan_max in each CTA and across
// the cluster in rank order, so a NaN in S reaches it (the drivers' LU
// fallback keys on resid < 1e-3 failing).  No atomics: two launches give
// the same bits.  The layout rule is ops/kernels/ns.py::ninv_layout.
#include "ns_chain.cuh"

namespace mpbqr {

// Dynamic shared memory of one CTA, in floats (ns.py::ninv_layout).
template <int R>
struct NinvLayout {
  static constexpr int CS = R / kStripe;            // CTAs of the cluster
  static constexpr int LDF = ChainLayout<R>::LDF;   // row pitch, floats
  static constexpr int FULL = R * LDF;              // a replicated matrix
  static constexpr int STRIPE = kStripe * LDF;      // 16 own columns
  static constexpr int OFF_S = 0;                   // S
  static constexpr int OFF_X = FULL;                // X, two buffers
  static constexpr int OFF_XT = 3 * FULL;           // own columns of X^T
  static constexpr int OFF_ET = OFF_XT + STRIPE;    // own columns of E^T
  static constexpr int OFF_PART = OFF_ET + STRIPE;  // prod_gen's partials
  static constexpr int OFF_RED = OFF_PART + kGenPart<R>;  // red, cred
  static constexpr int BYTES = (OFF_RED + 64) * 4;
};

// Per-CTA clock64 sums of a launch's phases, compiled in only with
// -DMPBQR_NINV_PROF; read by utils/ninv_probe.py --phases, which names the
// slots: 0 setup (S's load, X0, the first cluster barrier), 1 S X, 2 the
// block barrier after it, 3 the wait at the cluster barrier, 4 X E and the
// block barrier after it, 5 the all-gather's stores, 6 the arrival at the
// cluster barrier, 7 the residual and X out.
#ifdef MPBQR_NINV_PROF
__device__ long long g_ninv_prof[8][8];
#define PROF_INIT long long pt = clock64(), pacc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#define PROF(k) if (tid == 0) { const long long t = clock64(); pacc[k] += t - pt; pt = t; }
#define PROF_SAVE if (tid == 0) for (int k = 0; k < 8; ++k) g_ninv_prof[rank][k] = pacc[k];
#else
#define PROF_INIT
#define PROF(k)
#define PROF_SAVE
#endif

template <int R>
__global__ void __launch_bounds__(kChainThreads, 1)
ninv_kernel(const float* S, float* X, float* resid, int iters) {
  using L = NinvLayout<R>;
  constexpr int LDF = L::LDF;
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int c0 = kStripe * rank;  // first own column
  float* Ss = sm + L::OFF_S;
  float* Xt = sm + L::OFF_XT;
  float* Et = sm + L::OFF_ET;
  float* red = sm + L::OFF_RED;
  float* part = sm + L::OFF_PART;
  float* cred = red + 32;
  PROF_INIT

  load_full_async<R>(Ss, S, R);
  float* X0 = sm + L::OFF_X;
  for (int e = tid; e < R * R; e += kChainThreads) {
    const int i = e / R, j = e % R;
    X0[i * LDF + j] = i == j ? 2.0f / 3.0f : 0.f;
  }
  for (int e = tid; e < kStripe * R; e += kChainThreads) {
    const int q = e / R, k = e % R;
    Xt[q * LDF + k] = k == c0 + q ? 2.0f / 3.0f : 0.f;
  }
  cp_async_wait<0>();
  // S and X0 are in place, and every CTA runs before the first DSMEM write.
  cluster.sync();
  PROF(0)

  for (int it = 0; it < iters; ++it) {
    const float* Xc = sm + L::OFF_X + (it & 1) * L::FULL;
    // E[:, own] = 2I - S X[:, own]: D[p = k][q] = <S[k], X^T[own q]>.
    prod_gen<R>(Ss, Xt, part, [&](int p, int q, float v) {
      Et[q * LDF + p] = (p == c0 + q ? 2.f : 0.f) - v;
    });
    PROF(1)
    __syncthreads();
    PROF(2)
    // Every CTA's columns of the current X are in this CTA's buffer.
    if (it > 0) cluster_wait();
    PROF(3)
    // X[:, own] <- X E[:, own]: D[p = i][q] = <X[i], E^T[own q]>.
    prod_gen<R>(Xc, Et, part,
                [&](int p, int q, float v) { Xt[q * LDF + p] = v; });
    __syncthreads();
    PROF(4)
    if (it + 1 == iters) break;
    // Own columns into every CTA's other buffer: X[i][c0 + a .. + 3], this
    // CTA's by a plain store, the others' in an order that starts after
    // each CTA's own rank.
    float* dst = sm + L::OFF_X + ((it + 1) & 1) * L::FULL;
    for (int e = tid; e < 4 * R; e += kChainThreads) {
      const int i = e % R, a = 4 * (e / R);
      const float4 v = make_float4(Xt[a * LDF + i], Xt[(a + 1) * LDF + i],
                                   Xt[(a + 2) * LDF + i],
                                   Xt[(a + 3) * LDF + i]);
      float* loc = dst + i * LDF + c0 + a;
      *reinterpret_cast<float4*>(loc) = v;
#pragma unroll
      for (int d = 1; d < L::CS; ++d) {
        const int p = (rank + d) % L::CS;
        *reinterpret_cast<float4*>(cluster.map_shared_rank(loc, p)) = v;
      }
    }
    PROF(5)
    cluster_arrive();
    PROF(6)
  }

  // max|I - S X| on the own columns, and the own columns of X out.
  float m = 0.f;
  prod_gen<R>(Ss, Xt, part, [&](int p, int q, float v) {
    m = nan_max(m, fabsf((p == c0 + q ? 1.f : 0.f) - v));
  });
  for (int e = tid; e < 4 * R; e += kChainThreads) {
    const int i = e % R, a = 4 * (e / R);
    *reinterpret_cast<float4*>(X + (size_t)i * R + c0 + a) =
        make_float4(Xt[a * LDF + i], Xt[(a + 1) * LDF + i],
                    Xt[(a + 2) * LDF + i], Xt[(a + 3) * LDF + i]);
  }
  // max over the cluster, in rank order.
  m = blk_max(m, red);
  if (tid == 0) *cluster.map_shared_rank(cred + rank, 0) = m;
  cluster.sync();  // also: no CTA leaves while another may write into it
  if (rank == 0 && tid == 0) {
    float r = cred[0];
    for (int p = 1; p < L::CS; ++p) r = nan_max(r, cred[p]);
    *resid = r;
  }
  PROF(7)
  PROF_SAVE
}

template <int R>
static inline cudaError_t launch_ninv_r(cudaStream_t st, const float* S,
                                        float* X, float* resid, int iters,
                                        int ctas, int smem_bytes) {
  using L = NinvLayout<R>;
  if (ctas != L::CS || smem_bytes != L::BYTES) return cudaErrorInvalidValue;
  static bool fits = false;
  return launch_cluster(ninv_kernel<R>, L::CS, L::BYTES, st, fits, S, X,
                        resid, iters);
}

}  // namespace mpbqr

extern "C" {

#ifdef MPBQR_NINV_PROF
// Copy the phase clocks (8 x 8 signed 64-bit) to the host.
int mpbqr_ninv_prof(long long* prof) {
  return (int)cudaMemcpyFromSymbol(prof, mpbqr::g_ninv_prof,
                                   sizeof(mpbqr::g_ninv_prof));
}
#endif

// S (r x r, fp32, row-major, 16-byte aligned) -> X (r x r, 16-byte
// aligned) and *resid (one float), device pointers, one cluster launch on
// `stream`.  ctas and smem_bytes: ops/kernels/ns.py::ninv_layout(r), which
// must match the kernel's own layout.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an r the kernel does not take, a
// layout that differs from the kernel's or a negative iteration count.
int mpbqr_ninv_chain(const float* S, float* X, float* resid, int r,
                     int iters, int ctas, int smem_bytes, void* stream) {
  using namespace mpbqr;
  if (iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (r) {
    case 32: err = launch_ninv_r<32>(st, S, X, resid, iters, ctas, smem_bytes); break;
    case 64: err = launch_ninv_r<64>(st, S, X, resid, iters, ctas, smem_bytes); break;
    case 128: err = launch_ninv_r<128>(st, S, X, resid, iters, ctas, smem_bytes); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
