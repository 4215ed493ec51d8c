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
//
// Widths: the kernel is instantiated for R = 32, 64, 128 and runs any
// r <= R on the smallest R >= r (ns_chain.cuh, "Widths"): S and X zero
// beyond r, the identities of X0, E and the residual stop at r.  Beyond
// 128 (S and two X: 3 x 4 r (r + 4) bytes a CTA, 790 KB at r = 256)
// ninv_l2_kernel below runs the same iteration on ns_chain.cuh's L2 route.
//
// Batches: under jax.vmap the TPU kernel takes the batch as a grid axis;
// here one launch runs B clusters, grid (cluster, B), the member
// blockIdx.y (ns_chain.cuh, "Batches").  Both kernels only offset their
// pointers by the member (S and X by b r^2 floats, resid by b, the L2
// route's scratch by b scratch_floats), so every member gets the bits of
// a single launch on its S.
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
// cluster barrier, 7 the residual and X out.  A batched launch writes them
// from member 0 only.
#ifdef MPBQR_NINV_PROF
__device__ long long g_ninv_prof[8][8];
#define PROF_INIT long long pt = clock64(), pacc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#define PROF(k) if (tid == 0) { const long long t = clock64(); pacc[k] += t - pt; pt = t; }
#define PROF_SAVE if (tid == 0 && blockIdx.y == 0) for (int k = 0; k < 8; ++k) g_ninv_prof[rank][k] = pacc[k];
#else
#define PROF_INIT
#define PROF(k)
#define PROF_SAVE
#endif

// S and X are nr x nr (leading dimension nr), nr = R unless PAD (nr =
// n_arg <= R; ns_chain.cuh, "Widths"); member blockIdx.y's at the strides
// of `bt` (bt.g for S, bt.x for X, bt.resid).
template <int R, bool PAD>
__global__ void __launch_bounds__(kChainThreads, 1)
ninv_kernel(const float* S, int n_arg, float* X, float* resid, int iters,
            ChainBatch bt) {
  using L = NinvLayout<R>;
  const int nr = PAD ? n_arg : R;
  {
    const long long b = blockIdx.y;
    S += b * bt.g;
    X += b * bt.x;
    resid += b * bt.resid;
  }
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

  load_full_async<R>(Ss, S, nr, nr);
  float* X0 = sm + L::OFF_X;
  for (int e = tid; e < R * R; e += kChainThreads) {
    const int i = e / R, j = e % R;
    X0[i * LDF + j] = i == j && i < nr ? 2.0f / 3.0f : 0.f;
  }
  for (int e = tid; e < kStripe * R; e += kChainThreads) {
    const int q = e / R, k = e % R;
    Xt[q * LDF + k] = k == c0 + q && k < nr ? 2.0f / 3.0f : 0.f;
  }
  cp_async_wait<0>();
  // S and X0 are in place, and every CTA runs before the first DSMEM write.
  cluster.sync();
  PROF(0)

  for (int it = 0; it < iters; ++it) {
    const float* Xc = sm + L::OFF_X + (it & 1) * L::FULL;
    // E[:, own] = 2I - S X[:, own]: D[p = k][q] = <S[k], X^T[own q]>.
    prod_gen<R>(Ss, Xt, part, [&](int p, int q, float v) {
      Et[q * LDF + p] = (p == c0 + q && p < nr ? 2.f : 0.f) - v;
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
    m = nan_max(m, fabsf((p == c0 + q && p < nr ? 1.f : 0.f) - v));
  });
  if (nr == R && reinterpret_cast<uintptr_t>(X) % 16 == 0) {
    for (int e = tid; e < 4 * R; e += kChainThreads) {
      const int i = e % R, a = 4 * (e / R);
      *reinterpret_cast<float4*>(X + (size_t)i * R + c0 + a) =
          make_float4(Xt[a * LDF + i], Xt[(a + 1) * LDF + i],
                      Xt[(a + 2) * LDF + i], Xt[(a + 3) * LDF + i]);
    }
  } else {
    for (int e = tid; e < kStripe * R; e += kChainThreads) {
      const int i = e % R, q = e / R;
      if (i < nr && c0 + q < nr) X[(size_t)i * nr + c0 + q] = Xt[q * LDF + i];
    }
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
                                        int nr, float* X, float* resid,
                                        int iters, int batch,
                                        const ChainBatch& bt) {
  using L = NinvLayout<R>;
  static bool fits[2] = {false, false};
  return launch_cluster_batch(nr == R ? &ninv_kernel<R, false>
                                      : &ninv_kernel<R, true>,
                              L::CS, batch, L::BYTES, st, fits[nr != R], S,
                              nr, X, resid, iters, bt);
}

// K4 on ns_chain.cuh's L2 route, any n <= kMaxWidth: X and the own columns
// of E = 2I - S X in the global scratch (X twice), S read in place, CTA p
// owning the columns [p cw, (p + 1) cw):
//   E[:, own] = 2I - S X[:, own];  X'[:, own] = X E[:, own]
// one cluster barrier an iteration (X' goes to the other buffer), then
// max|I - S X| on the own columns and a rank-ordered max over the cluster.
// Member blockIdx.y's S, X, resid and scratch at the strides of `bt`.
// Dynamic shared memory: kL2StageFloats + 64 floats.
__global__ void __launch_bounds__(kChainThreads, 1)
ninv_l2_kernel(const float* S, int n, float* X, float* resid, int iters,
               float* scratch, ChainBatch bt) {
  {
    const long long b = blockIdx.y;
    S += b * bt.g;
    X += b * bt.x;
    resid += b * bt.resid;
    scratch += b * bt.scratch;
  }
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  int c0, c1;
  l2_own(n, (int)cluster.block_rank(), (int)gridDim.x, c0, c1);
  const int ld = l2_ld(n), cw = c1 - c0;
  const size_t mat = (size_t)n * ld;
  float* Xb[2] = {scratch, scratch + mat};
  float* Eb = scratch + 2 * mat;
  float* stage = sm;
  float* red = sm + kL2StageFloats;
  float* cred = red + 32;
  for (int e = tid; e < n * cw; e += kChainThreads) {
    const int i = e / cw, c = c0 + e % cw;
    Xb[0][i * ld + c] = i == c ? 2.0f / 3.0f : 0.f;
  }
  l2_barrier(cluster);
  for (int it = 0; it < iters; ++it) {
    const float* Xc = Xb[it & 1];
    float* Xn = Xb[(it + 1) & 1];
    l2_prod<false, false>(n, S, n, Xc, ld, c0, c1, 0, stage,
                          [&](int i, int c, float v) {
                            Eb[i * ld + c] = (i == c ? 2.f : 0.f) - v;
                          });
    __syncthreads();
    l2_prod<false, false>(n, Xc, ld, Eb, ld, c0, c1, 0, stage,
                          [&](int i, int c, float v) { Xn[i * ld + c] = v; });
    l2_barrier(cluster);
  }
  const float* Xf = Xb[iters & 1];
  float m = 0.f;
  l2_prod<false, false>(n, S, n, Xf, ld, c0, c1, 0, stage,
                        [&](int i, int c, float v) {
                          m = nan_max(m, fabsf((i == c ? 1.f : 0.f) - v));
                        });
  for (int e = tid; e < n * cw; e += kChainThreads) {
    const int i = e / cw, c = c0 + e % cw;
    X[(size_t)i * n + c] = __ldcg(Xf + i * ld + c);
  }
  l2_cluster_max(cluster, m, red, cred, RESID_RAW, resid);
}

static inline int ninv_smem_bytes(int r) {
  switch (chain_inst(r)) {
    case 32: return NinvLayout<32>::BYTES;
    case 64: return NinvLayout<64>::BYTES;
    case 128: return NinvLayout<128>::BYTES;
    default: return (kL2StageFloats + 64) * 4;
  }
}

// Whether `lay` is K4's layout for width r (ns.py::ninv_layout).
static inline bool ninv_layout_ok(int r, const KernelLayout& lay) {
  if (r < 1 || r > kMaxWidth) return false;
  const int inst = chain_inst(r);
  if (lay.inst != inst || lay.route != (inst ? 0 : 1) ||
      lay.smem_bytes != ninv_smem_bytes(r))
    return false;
  if (inst) return lay.ctas == inst / kStripe && lay.scratch_floats == 0;
  return lay.ctas >= 1 && lay.ctas <= l2_max_ctas(r) &&
         lay.scratch_floats == 3LL * r * l2_ld(r);
}

// How many K4 clusters of the layout `lay` (checked by the caller) the card
// keeps resident at once, in *out.
static inline cudaError_t ninv_resident(int r, const KernelLayout& lay,
                                        int* out) {
  switch (lay.inst) {
#define MPBQR_RES(RR)                                                        \
  case RR:                                                                   \
    return cluster_resident(r == RR ? &ninv_kernel<RR, false>                \
                                    : &ninv_kernel<RR, true>,                \
                            NinvLayout<RR>::CS, NinvLayout<RR>::BYTES, out)
    MPBQR_RES(32);
    MPBQR_RES(64);
    MPBQR_RES(128);
#undef MPBQR_RES
    default: break;
  }
  return cluster_resident(ninv_l2_kernel, lay.ctas, lay.smem_bytes, out);
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

// The batched K4: B Newton inverses of one width and iteration count in
// ONE launch of B clusters (grid (ctas, B), blockIdx.y the member).  S and
// X are B x r x r contiguous (member b at b r^2 floats), resid B floats,
// and `scratch` holds B x scratch_floats (one L2-route scratch a member;
// none on the shared-memory route).  Member b's X and resid are bit for
// bit those of mpbqr_ninv_chain on its S.  The other arguments as
// mpbqr_ninv_chain takes them.  Returns cudaErrorInvalidValue for a B
// outside 1 .. 65535, else as mpbqr_ninv_chain.
int mpbqr_ninv_chain_batched(const float* S, float* X, float* resid,
                             float* scratch, int B, int r, int iters,
                             int inst, int route, int ctas,
                             int scratch_floats, int smem_bytes,
                             void* stream) {
  using namespace mpbqr;
  const KernelLayout lay{inst, route, ctas, scratch_floats, smem_bytes};
  if (iters < 0 || !ninv_layout_ok(r, lay) || B < 1 || B > kMaxBatch)
    return (int)cudaErrorInvalidValue;
  const long long rr = (long long)r * r;
  const ChainBatch bt{rr, rr, 0, 1, scratch_floats};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (inst) {
    case 32: err = launch_ninv_r<32>(st, S, r, X, resid, iters, B, bt); break;
    case 64: err = launch_ninv_r<64>(st, S, r, X, resid, iters, B, bt); break;
    case 128:
      err = launch_ninv_r<128>(st, S, r, X, resid, iters, B, bt);
      break;
    default: {
      static bool fits[kL2MaxCluster + 1] = {};
      err = launch_cluster_batch(ninv_l2_kernel, ctas, B, smem_bytes, st,
                                 fits[ctas], S, r, X, resid, iters, scratch,
                                 bt);
    }
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// S (r x r, fp32, row-major) -> X (r x r) and *resid (one float), device
// pointers, one cluster launch on `stream`; `scratch` holds the layout's
// scratch floats (the L2 route's X and E).  inst, route, ctas,
// scratch_floats, smem_bytes: ops/kernels/ns.py::ninv_layout(r, ...),
// which must match the kernel's own layout.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an r outside 1 ..
// kMaxWidth, a layout that differs from the kernel's or a negative
// iteration count.  The batched entry's B = 1.
int mpbqr_ninv_chain(const float* S, float* X, float* resid, float* scratch,
                     int r, int iters, int inst, int route, int ctas,
                     int scratch_floats, int smem_bytes, void* stream) {
  return mpbqr_ninv_chain_batched(S, X, resid, scratch, 1, r, iters, inst,
                                  route, ctas, scratch_floats, smem_bytes,
                                  stream);
}

// How many K4 clusters of the layout (ns.py::ninv_layout(r, ...)) the card
// keeps resident at once, in *out: a batch of B runs in ceil(B / *out)
// waves.  Returns cudaErrorInvalidValue for a layout the kernel does not
// run, else the CUDA error of the query.
int mpbqr_ninv_chain_resident(int r, int inst, int route, int ctas,
                              int scratch_floats, int smem_bytes, int* out) {
  using namespace mpbqr;
  const KernelLayout lay{inst, route, ctas, scratch_floats, smem_bytes};
  *out = 0;
  if (!ninv_layout_ok(r, lay)) return (int)cudaErrorInvalidValue;
  return (int)ninv_resident(r, lay, out);
}

}  // extern "C"
