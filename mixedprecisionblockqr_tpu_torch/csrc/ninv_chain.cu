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
// cluster barrier, 7 the residual and X out.  The L2 route
// (ninv_l2_kernel) has slots of its own (NL_*): the setup (X0 seeded, the
// first cluster barrier), the products S X (E) and X E, the waits at the
// iterations' cluster barriers with their __threadfence, the residual's
// product S X, the X store and the residual's cluster max; one record a
// CTA of the largest cluster (16).  A batched launch writes them from
// member 0 only.
enum {
  NL_SETUP, NL_PROD_SX, NL_PROD_XE, NL_BARRIER, NL_RESIDUAL, NL_X_STORE,
  NL_CLUSTER_MAX, NL_SLOTS
};
#ifdef MPBQR_NINV_PROF
__device__ long long g_ninv_prof[8][8];
__device__ long long g_ninv_l2_prof[16][NL_SLOTS];
#define PROF_INIT long long pt = clock64(), pacc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#define PROF(k) if (tid == 0) { const long long t = clock64(); pacc[k] += t - pt; pt = t; }
#define PROF_SAVE if (tid == 0 && blockIdx.y == 0) for (int k = 0; k < 8; ++k) g_ninv_prof[rank][k] = pacc[k];
#define PROF_SAVE_L2 if (tid == 0 && blockIdx.y == 0) for (int k = 0; k < NL_SLOTS; ++k) g_ninv_l2_prof[rank][k] = pacc[k];
#else
#define PROF_INIT
#define PROF(k)
#define PROF_SAVE
#define PROF_SAVE_L2
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

// K4 on ns_chain.cuh's L2 route, any n <= kMaxWidth.
//
// What its clock showed (utils/ninv_probe.py --phases --l2, H100, r = 256
// and 5 iterations on the route's first products: 128 x 16 tiles, 32-deep
// stages staged through registers, two block barriers a stage, 8 rows x 1
// column a thread): the products took 95% of a launch of 546k cycles, S X
// 47.7k and X E 45.0k an iteration on every CTA alike (~22 FMA a cycle of
// the SM's 128: three shared-memory loads for 8 FMA), the residual's S X
// 57.4k; the barriers 2.5k an iteration, the setup 4.3k, the X store
// 5.7k.  The design runs every product on l2_tprod's stages instead
// (ns_chain.cuh, "K1's chain on the L2 route"): 64-deep stages of A and B
// by the copy engine into a ring of kL2Stages slots with full / empty
// mbarriers and no block barrier a stage, 4 x 4 fp32 register tiles (8
// 16-byte loads a k-quad for 64 FMA), the columns dealt in tiles of 8.
// Its products are full, so the dealing only spreads the tiles; every A
// is read k-major (D = A^T B), so the scratch keeps the transposes the
// products need:
//   E[:, own] = 2I - S X[:, own]        A = S^T (written once, in the setup)
//   X'[:, own] = X E[:, own]            A = X^T (written with X' by the
//                                       same epilogue, into the other buffer)
//   resid = max|I - S X_f| on the own columns, then over the cluster.
// E's own columns are read only by their owner, so a block barrier after
// the epilogue's proxy fence separates the two products; X and X^T are
// double-buffered, so one cluster barrier an iteration separates the X E
// that reads X^T whole from the next one that writes it.  The last
// iteration needs none (the residual reads only the own columns of X_f
// and the constant S^T) and writes X out from its epilogue.  Each element
// sums k ascending from 0 by fmaf into one accumulator, as the products
// before did, so X and resid keep their bits.  Member blockIdx.y's S, X,
// resid and scratch at the strides of `bt`; mapA / mapB describe the
// launch's scratch (l2_maps, kL2NinvMats a member).  Dynamic shared
// memory: kL2RingSlack + kL2RingFloats + 64 floats.
//
// The scratch: n x l2_ld(n) floats each of S^T, X (twice), X^T (twice) and
// E, in this order (the third coordinate of the tensor maps).
enum { L2N_ST = 0, L2N_X = 1, L2N_XT = 3, L2N_E = 5, kL2NinvMats = 6 };

__global__ void __launch_bounds__(kChainThreads, 1)
ninv_l2_kernel(const float* S, int n, float* X, float* resid, int iters,
               float* scratch, ChainBatch bt,
               const __grid_constant__ CUtensorMap mapA,
               const __grid_constant__ CUtensorMap mapB) {
  {
    const long long b = blockIdx.y;
    S += b * bt.g;
    X += b * bt.x;
    resid += b * bt.resid;
    scratch += b * bt.scratch;
  }
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, rank = (int)cluster.block_rank();
  const int cs = (int)gridDim.x;
  (void)tid;  // the clock's (PROF)
  PROF_INIT
  const int ld = l2_ld(n);
  const size_t mat = (size_t)n * ld;
  float* ST = scratch + L2N_ST * mat;
  float* Xb[2] = {scratch + L2N_X * mat, scratch + (L2N_X + 1) * mat};
  float* XTb[2] = {scratch + L2N_XT * mat, scratch + (L2N_XT + 1) * mat};
  float* Eb = scratch + L2N_E * mat;
  const int mat0 = kL2NinvMats * (int)blockIdx.y;  // the member's first
  const CUtensorMap* mA = &mapA;
  const CUtensorMap* mB = &mapB;
  L2Ring ring = l2_ring_init(sm);
  float* red = sm + kL2RingSlack + kL2RingFloats;
  float* cred = red + 32;

  // Setup: the own rows of S^T (S's own columns), the own columns of X0 =
  // (2/3) I and the own rows of X0^T (and X0 itself out when no iteration
  // will write X).
  l2_own_each(n, rank, cs, [&](int i, int c) {
    ST[c * ld + i] = __ldg(S + (size_t)i * n + c);
    const float x = i == c ? 2.0f / 3.0f : 0.f;
    Xb[0][i * ld + c] = x;
    XTb[0][c * ld + i] = x;
    if (iters == 0) X[(size_t)i * n + c] = x;
  });
  l2_fence_proxy_global();
  l2_barrier(cluster);
  PROF(NL_SETUP)
  // The products' epilogues take a thread's 4 x 4 tile (l2_tprod's TILE:
  // rows i .. i + 3, i < n; columns c .. c + 3, c < ld), stored as 16-byte
  // pieces.  The columns past n of E and X hold whatever their
  // products give there: a product's column reads only its own column of
  // B, so they reach no column below n, and no row of X^T past n is
  // written.
  for (int it = 0; it < iters; ++it) {
    const int cur = it & 1;
    const bool last = it + 1 == iters;
    // E[:, own] = 2I - S X[:, own], read by this CTA only.
    l2_tprod<false, true>(
        n, L2N_ST, L2N_X + cur, mA, mB, mat0, ld, rank, cs, 0, ring,
        L2NoOld(), [&](int i, int c, const float(&acc)[16]) {
#pragma unroll
          for (int a = 0; a < 4; ++a)
            if (i + a < n)
              *reinterpret_cast<float4*>(Eb + (i + a) * ld + c) =
                  make_float4((i + a == c ? 2.f : 0.f) - acc[4 * a],
                              (i + a == c + 1 ? 2.f : 0.f) - acc[4 * a + 1],
                              (i + a == c + 2 ? 2.f : 0.f) - acc[4 * a + 2],
                              (i + a == c + 3 ? 2.f : 0.f) - acc[4 * a + 3]);
        });
    __syncthreads();
    PROF(NL_PROD_SX)
    // X'[:, own] = X E[:, own] and the own rows of X'^T, into the other
    // buffers; the last iteration's X' goes out instead of into X^T.
    float* Xn = Xb[cur ^ 1];
    float* XTn = XTb[cur ^ 1];
    l2_tprod<false, true>(
        n, L2N_XT + cur, L2N_E, mA, mB, mat0, ld, rank, cs, 0, ring,
        L2NoOld(), [&](int i, int c, const float(&acc)[16]) {
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            if (i + a >= n) break;
            *reinterpret_cast<float4*>(Xn + (i + a) * ld + c) =
                make_float4(acc[4 * a], acc[4 * a + 1], acc[4 * a + 2],
                            acc[4 * a + 3]);
            if (last) {
#pragma unroll
              for (int b = 0; b < 4; ++b)
                if (c + b < n) X[(size_t)(i + a) * n + c + b] = acc[4 * a + b];
            }
          }
          if (last) return;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (c + b < n)
              *reinterpret_cast<float4*>(XTn + (c + b) * ld + i) =
                  make_float4(acc[b], acc[4 + b], acc[8 + b], acc[12 + b]);
        });
    PROF(NL_PROD_XE)
    if (last)
      __syncthreads();
    else
      l2_barrier(cluster);
    PROF(NL_BARRIER)
  }
  // max|I - S X_f| on the own columns.
  float m = 0.f;
  l2_tprod<false>(n, L2N_ST, L2N_X + (iters & 1), mA, mB, mat0, ld, rank,
                  cs, 0, ring, L2NoOld(), [&](int i, int c, float v, float) {
                    m = nan_max(m, fabsf((i == c ? 1.f : 0.f) - v));
                  });
  PROF(NL_RESIDUAL)
  // X went out with the last X E (or the setup): nothing is left to store.
  PROF(NL_X_STORE)
  l2_cluster_max(cluster, m, red, cred, RESID_RAW, resid);
  PROF(NL_CLUSTER_MAX)
  PROF_SAVE_L2
}

// Floats of K4's L2 scratch for width n (one member).
static inline long long ninv_l2_scratch_floats(int n) {
  return (long long)kL2NinvMats * n * l2_ld(n);
}

static inline int ninv_smem_bytes(int r) {
  switch (chain_inst(r)) {
    case 32: return NinvLayout<32>::BYTES;
    case 64: return NinvLayout<64>::BYTES;
    case 128: return NinvLayout<128>::BYTES;
    default: return (kL2RingSlack + kL2RingFloats + 64) * 4;
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
         lay.scratch_floats == ninv_l2_scratch_floats(r);
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
// Copy the phase clocks to the host: the shared-memory route's (8 x 8
// signed 64-bit) into `prof`, the L2 route's (16 x NL_SLOTS) into
// `prof_l2`.
int mpbqr_ninv_prof(long long* prof, long long* prof_l2) {
  cudaError_t err = cudaMemcpyFromSymbol(prof, mpbqr::g_ninv_prof,
                                         sizeof(mpbqr::g_ninv_prof));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(prof_l2, mpbqr::g_ninv_l2_prof,
                                   sizeof(mpbqr::g_ninv_l2_prof));
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
      // One pair of tensor maps over the B members' scratch, back to back.
      CUtensorMap mapA, mapB;
      err = l2_maps(scratch, r, B, kL2NinvMats, &mapA, &mapB);
      if (err != cudaSuccess) return (int)err;
      static bool fits[kL2MaxCluster + 1] = {};
      err = launch_cluster_batch(ninv_l2_kernel, ctas, B, smem_bytes, st,
                                 fits[ctas], S, r, X, resid, iters, scratch,
                                 bt, mapA, mapB);
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
