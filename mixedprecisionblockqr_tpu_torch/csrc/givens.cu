// The three Givens-rotation kernels of the streaming QR family
// (ops/givens.py, models/lstsq.py::rls_update), each one launch per chain:
//
//   G1 givens_fold_rows  -- fold k new rows of width W into an n x W
//                           augmented upper-triangular factor (n pivots);
//   G2 givens_chain      -- a bottom-up chain of adjacent-row rotations
//                           whose coefficients come from a vector that the
//                           chain itself rotates, applied to the rows of two
//                           matrices (R and Q^T);
//   G3 givens_hessenberg -- the top-down re-triangularization of an upper
//                           Hessenberg H, applied to the rows of H and Q^T.
//
// None of them replaces a pl.pallas_call: the JAX package runs these loops
// as lax.scan / lax.fori_loop programs (mixedprecisionblockqr_tpu/ops/
// givens.py:289 _fold_rows_run; :256 sweep_up, :473 and :536 the bottom-up
// chains of qr_insert_col and qr_delete_row; :273 sweep_down and :412
// qr_delete_col's chain).  An eager PyTorch loop of the same rotations is
// ~10 launches a rotation, so each loop is one kernel here.
//
// Arithmetic (the reference's, ops/givens.py::givens_rotation): for a pair
// (a, b), r = hypot(a, b), c = a / r, s = -b / r, and (1, 0) when r = 0 (a
// NaN r too); rows (lo, hi) become (c lo - s hi, s lo + c hi).  Every
// product, sum and quotient is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn: no contraction into FMA), as the plain PyTorch
// versions (ops/kernels/givens.py) round them, so a kernel repeats its plain
// version's values.  No atomics: two launches give the same bits.
//
// What bounds them on this card: not bytes or operations (6 fp32
// operations a rotated pair, each entry read and written once) but the
// serial chain of coefficients, one hypot and two divisions a step, each
// step waiting for the one before.
//   * G1: the pair (pivot p, row t) needs (p - 1, t) and (p, t - 1) only,
//     so the k n coefficients form a wavefront of n + k - 1 diagonals
//     d = p + t instead of a chain of k n.  One warp (a CTA of 32 threads)
//     owns 32 consecutive columns; lane j keeps its column of up to 16 rows
//     (a block; more rows run as further blocks) and, in slot t, the
//     running R[p, j] of the pivot p = d - t, all in registers, and steps
//     the diagonals: the lane of column p makes coefficient (p, t) from its
//     slot t and row t, then every column > p applies it.  A warp hands its
//     coefficients to the warps on its right through global memory (see
//     "coefficients" below); R's rows are loaded kPf diagonals ahead.
//   * G2: the coefficients depend on the vector alone, so every CTA
//     computes all of them itself (lane 0 of warp 0, from the vector staged
//     in shared memory) and publishes its progress through a shared-memory
//     counter; the CTA's other three warps each own one column of [X1 | X2]
//     and walk it bottom-up, carrying the row below in a register and
//     loading kChainBlock rows ahead, so each entry is read and written
//     once and the walk runs as fast as the chain produces.  No exchange
//     between CTAs.
//   * G3: coefficient i needs column i after rotations 0..i-1.  A warp owns
//     32 consecutive columns of [H | Q^T] and steps i, each lane carrying
//     its column's running row i and loading rows kPf ahead.  While
//     coefficient i is made in the warp every lane computes it, from column
//     i's last inputs that its lane shuffled to the warp one step before:
//     nothing passes between lanes between two coefficients of one warp.
//     The other warps of the CTA read it from a table of self-flagging
//     words in shared memory, later CTAs from the same words in global
//     memory (ops/kernels/givens.py::hessenberg_layout: `warps` a CTA).
//     Column j of H is finished after step j (zero below row j + 1): the
//     rotations of its entries below the diagonal are not done (the
//     callers' triu drops them).
//   G1 and G3 launch cooperatively, so all their CTAs are resident while
//   they wait on each other.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChainThreads = 128;               // warp 0 + three walkers
constexpr int kChainCols = kChainThreads - 32;   // columns a CTA walks
constexpr int kChainBlock = 16;                  // rows a walker loads ahead
constexpr int kChainPublish = 8;                 // coefficients a publish

__device__ __forceinline__ void rotation(float a, float b, float& c,
                                         float& s) {
  const float r = hypotf(a, b);
  if (r > 0.f) {
    c = __fdiv_rn(a, r);
    s = __fdiv_rn(-b, r);
  } else {
    c = 1.f;
    s = 0.f;
  }
}

// The same values as rotation(), with the r > 0 test a selection, so that
// a warp whose lanes compute it together does not branch on it.  A zero
// dividend would send __fdiv_rn down its slow path (an already triangular
// input has zeros below its diagonal); its quotient is the dividend itself
// (r > 0), so it is selected, not divided.
__device__ __forceinline__ void rotation_sel(float a, float b, float& c,
                                             float& s) {
  const float r = hypotf(a, b);
  const bool ok = r > 0.f;
  const float rs = ok ? r : 1.f;
  const float cq = __fdiv_rn(a == 0.f ? 1.f : a, rs);
  const float sq = __fdiv_rn(b == 0.f ? 1.f : -b, rs);
  c = ok ? (a == 0.f ? a : cq) : 1.f;
  s = ok ? (b == 0.f ? -b : sq) : 0.f;
}

// The new lo row, c lo - s hi, and the new hi row, s lo + c hi.
__device__ __forceinline__ float rot_lo(float c, float s, float lo,
                                        float hi) {
  return __fsub_rn(__fmul_rn(c, lo), __fmul_rn(s, hi));
}
__device__ __forceinline__ float rot_hi(float c, float s, float lo,
                                        float hi) {
  return __fadd_rn(__fmul_rn(s, lo), __fmul_rn(c, hi));
}

// ------------------------------------------------------ coefficients ----
// G1 and G3 pass coefficients between CTAs through global memory as one
// 64-bit word (c in the low half, s in the high half), written once; a word
// still holding the sentinel (all ones, which no canonical float pair
// gives) has not been written yet.  So a word is its own flag: no fence, no
// counter.  A wait that outlasts kSpinLimit polls (a fault: every producer
// runs, the launch is cooperative) sets *abort, and every warp then takes
// NaN for what it waits on and runs to its end; the wrapper reads *abort
// after the launch and raises.  Inside a G3 CTA the same words sit in
// shared memory, set to the sentinel at the start.
constexpr unsigned long long kSent = ~0ull;
constexpr int kSpinLimit = 1 << 22;
constexpr int kPf = 8;     // rows a lane loads ahead
constexpr int kExtQ = kPf; // diagonals of G1 coefficients a lane loads ahead
constexpr int kSlots = 16; // rows of G1 in one block (registers)
constexpr int kHessMaxWarps = 8;  // warps of a G3 CTA at most

// Per-warp clock64 sums of a launch's step phases, compiled in only with
// -DMPBQR_GIVENS_PROF; read by utils/givens_probe.py --phases, which names
// the slots.  Each step of a warp is a front step when the warp makes a
// coefficient in it, else a follower step (slots + kGpFollow).
constexpr int kGpMake = 0;     // making the coefficient
constexpr int kGpHand = 1;     // handing it on inside the warp or CTA
constexpr int kGpWaitCta = 2;  // waiting on another CTA
constexpr int kGpApply = 3;    // applying it
constexpr int kGpBarrier = 4;  // the CTA barrier
constexpr int kGpWaitWarp = 5; // waiting on another warp of the CTA
constexpr int kGpSteps = 6;    // steps counted
constexpr int kGpFollow = 8;
constexpr int kGpTotal = 15;   // the warp's whole clock
constexpr int kGpFirst = 16;   // %globaltimer (ns) at its first front step
constexpr int kGpLast = 17;    // %globaltimer (ns) at its last front step
constexpr int kGpSlots = 18;
constexpr int kGpWarps = 2048;
#ifdef MPBQR_GIVENS_PROF
__device__ long long g_gv_prof[kGpWarps][kGpSlots];
#define GP_INIT                                                  \
  long long gp_t = clock64(), gp_t0 = gp_t, gp_acc[kGpSlots];    \
  for (int gp_k = 0; gp_k < kGpSlots; ++gp_k) gp_acc[gp_k] = 0;  \
  int gp_off = 0;
#define GP_STEP(front)                                           \
  gp_off = __any_sync(0xffffffffu, (front)) ? 0 : kGpFollow;     \
  gp_acc[kGpSteps + gp_off] += 1;                                \
  if (gp_off == 0) {                                             \
    long long gp_g;                                              \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gp_g));     \
    if (gp_acc[kGpFirst] == 0) gp_acc[kGpFirst] = gp_g;          \
    gp_acc[kGpLast] = gp_g;                                      \
  }
#define GP(k)                                                    \
  {                                                              \
    const long long gp_n = clock64();                            \
    gp_acc[(k) + gp_off] += gp_n - gp_t;                         \
    gp_t = gp_n;                                                 \
  }
#define GP_SAVE(w)                                               \
  if ((threadIdx.x & 31) == 0 && (int)(w) < kGpWarps) {          \
    gp_acc[kGpTotal] = clock64() - gp_t0;                        \
    for (int gp_k = 0; gp_k < kGpSlots; ++gp_k)                  \
      g_gv_prof[w][gp_k] = gp_acc[gp_k];                         \
  }
#else
#define GP_INIT
#define GP_STEP(front)
#define GP(k)
#define GP_SAVE(w)
#endif

__device__ __forceinline__ unsigned long long pack(float c, float s) {
  if (c != c) c = __int_as_float(0x7fffffff);  // never the sentinel
  return (unsigned long long)__float_as_uint(c) |
         ((unsigned long long)__float_as_uint(s) << 32);
}
__device__ __forceinline__ float coef_c(unsigned long long v) {
  return __uint_as_float((unsigned)v);
}
__device__ __forceinline__ float coef_s(unsigned long long v) {
  return __uint_as_float((unsigned)(v >> 32));
}
__device__ __forceinline__ unsigned long long ld_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_word(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}
// st_word where `on`, as one predicated store (no branch in the warp).
__device__ __forceinline__ void st_word_if(bool on, unsigned long long* p,
                                           unsigned long long v) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t"
      "@q st.relaxed.gpu.global.u64 [%0], %1;\n\t}" ::"l"(p),
      "l"(v), "r"((unsigned)on)
      : "memory");
}
__device__ __forceinline__ unsigned long long nan_word() {
  return pack(__int_as_float(0x7fffffff), __int_as_float(0x7fffffff));
}
// True (and *abort set) once a wait has polled `spins` times past the
// limit, or another wait has aborted; checks the flag every 256 polls.
__device__ __forceinline__ bool give_up(int spins, int* abort) {
  if (spins >= kSpinLimit || (spins % 256 == 255 && *(volatile int*)abort)) {
    *(volatile int*)abort = 1;
    return true;
  }
  return false;
}
// The word at p once written (see above).
__device__ unsigned long long wait_word(
    const unsigned long long* p, int* abort) {
  unsigned long long v = ld_word(p);
  for (int spins = 0; v == kSent; ++spins) {
    if (give_up(spins, abort)) return nan_word();
    __nanosleep(64);
    v = ld_word(p);
  }
  return v;
}

// A word of the CTA's table in shared memory (self-flagging like the
// global ones), once written: read, and polled with a short sleep between
// reads (out of line, so that the hot loops stay small) only while it
// holds the sentinel.
__device__ __forceinline__ unsigned long long ld_shared(
    const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}
__device__ __forceinline__ void st_shared(unsigned long long* p,
                                          unsigned long long v) {
  *(volatile unsigned long long*)p = v;
}
__device__ __noinline__ unsigned long long wait_shared(
    const unsigned long long* p, int* abort) {
  unsigned long long v = ld_shared(p);
  for (int spins = 0; v == kSent; ++spins) {
    if (give_up(spins, abort)) return nan_word();
    __nanosleep(32);
    v = ld_shared(p);
  }
  return v;
}
__device__ __forceinline__ unsigned long long get_shared(
    const unsigned long long* p, int* abort) {
  const unsigned long long v = ld_shared(p);
  return v != kSent ? v : wait_shared(p, abort);
}

// ---------------------------------------------------------------- G1 ----
// R (n x W, row stride W) <- R with the k rows of `rows` (k x W) folded in.
// One CTA per 32 consecutive columns; the rows in blocks of NS <= kSlots
// (ops/kernels/givens.py::fold_layout).
// In slot t lane j keeps row t's entry of column j (rw) and the running
// R[p, j] of the pivot p = d - t that row t meets at diagonal d (cr).
// Coefficient (p, t) (pivot p against row t) is made at diagonal p + t by
// the lane of column p, from R[p, p] after rows < t (xd) and row t after
// pivots < p, and used by every column > p at the same diagonal: in the
// CTA through shared memory, in later CTAs through coef[block][d][t].
// The slots are split over the CTA's NS / SPW warps, SPW each, so that
// one diagonal's rotations run on several warps; a pivot's running R[p, j]
// and R[p, p] pass from a warp's last slot to the next warp's first
// through shared memory, one CTA barrier a diagonal.  Inside a warp the
// slots are applied without branches (every slot computed, kept where it
// is live).
template <int NS>
struct FoldShape {
  static constexpr int SPW = NS < 4 ? NS : 4;  // slots a warp
  static constexpr int NW = NS / SPW;          // warps
};

template <int NS>
__global__ void __launch_bounds__(32 * FoldShape<NS>::NW)
fold_rows_kernel(float* __restrict__ R, const float* __restrict__ rows,
                 int n, int W, int k, unsigned long long* __restrict__ coef,
                 int* abort) {
  constexpr int SPW = FoldShape<NS>::SPW, NW = FoldShape<NS>::NW;
  // The diagonal's coefficient for each row t, double-buffered: written by
  // the lane of column p = d - t when p is in this CTA, else by the lane
  // that loads row t's word from an earlier CTA.
  __shared__ unsigned long long cf[2][NS];
  // Each lane's rows after the last diagonal, for the row its coefficient
  // needs (registers cannot be indexed at run time).
  __shared__ float rws[NS][32];
  // A pivot's running R[p, j] (crx) and R[p, p] (xdx) into warp q's first
  // slot, double-buffered by diagonal.
  __shared__ float crx[2][NW][32], xdx[2][NW][32];
  const int q = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t0 = q * SPW;                    // this warp's first slot
  const int g0 = blockIdx.x * 32;
  const int j = g0 + lane;
  const bool live = j < W;
  const int jmax = min(j, n - 1);            // the pivots of column j
  const int wlast = min(g0 + 31, W - 1);     // the CTA's last column
  const int ndiag = n + kSlots;              // diagonals a block stores
  GP_INIT
  for (int b0 = 0, blk = 0; b0 < k; b0 += NS, ++blk) {
    const int nbk = min(NS, k - b0);
    unsigned long long* cb = coef + (size_t)blk * ndiag * kSlots;
    float rw[SPW], cr[SPW], pf[kPf];
    float xd = 0.f;  // R[j, j] while column j makes its coefficients here
    unsigned long long eq[kExtQ];
#pragma unroll
    for (int s = 0; s < SPW; ++s) {
      const int t = t0 + s;
      rw[s] = (live && t < nbk) ? rows[(size_t)(b0 + t) * W + j] : 0.f;
      rws[t][lane] = rw[s];
      cr[s] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kPf; ++i)
      pf[i] = (q == 0 && live && i <= jmax) ? R[(size_t)i * W + j] : 0.f;
    const bool loader = lane < SPW && t0 + lane < nbk;  // of row t0 + lane
#pragma unroll
    for (int i = 0; i < kExtQ; ++i)
      eq[i] = (loader && i < ndiag)
                  ? ld_word(cb + (size_t)i * kSlots + t0 + lane) : kSent;
    const int dend = min(wlast, n - 1) + nbk - 1;
    // kPf diagonals an iteration, unrolled, so that pf[u] and eq[u] are
    // reloaded in place: a queue shifted by moves would wait for each load
    // a diagonal after issuing it.
    for (int d0 = 0; d0 <= dend; d0 += kPf) {
#pragma unroll
      for (int u = 0; u < kPf; ++u) {
        const int d = d0 + u;
        if (d > dend) break;
        const int par = d & 1;
        const int tp = d - j;
        GP_STEP(live && j < n && tp >= t0 && tp < t0 + SPW && tp < nbk)
        // Pivot d enters slot 0; the others move one slot on.
#pragma unroll
        for (int s = SPW - 1; s > 0; --s) cr[s] = cr[s - 1];
        if (q == 0) {
          cr[0] = pf[u];
          pf[u] = (live && d + kPf <= jmax) ? R[(size_t)(d + kPf) * W + j]
                                            : 0.f;
        } else {
          cr[0] = crx[par][q][lane];
        }
        GP(kGpHand)
        // Column j makes coefficient (j, d - j) if row d - j is here.
        if (live && j < n && tp >= t0 && tp < t0 + SPW && tp < nbk) {
          const float x = tp == 0 ? cr[0] : tp == t0 ? xdx[par][q][lane]
                                                     : xd;
          const float a = rws[tp][lane];
          float c, s;
          rotation(x, a, c, s);
          xd = rot_lo(c, s, x, a);
          if (q < NW - 1 && tp == t0 + SPW - 1) xdx[par ^ 1][q + 1][lane] = xd;
          const unsigned long long v = pack(c, s);
          cf[par][tp] = v;
          st_word(cb + (size_t)d * kSlots + tp, v);
        }
        GP(kGpMake)
        // Earlier CTAs' coefficients: the loader of row t.
        if (loader) {
          const int t = t0 + lane, p = d - t;
          if (p >= 0 && p < min(g0, n)) {
            unsigned long long v = eq[u];
            if (v == kSent)
              v = wait_word(cb + (size_t)d * kSlots + t, abort);
            cf[par][t] = v;
          }
          eq[u] = d + kExtQ < ndiag
                      ? ld_word(cb + (size_t)(d + kExtQ) * kSlots + t) : kSent;
        }
        GP(kGpWaitCta)
        __syncwarp();
        GP(kGpHand)
        // Pivot p = d - t against row t, for the columns > p.
#pragma unroll
        for (int s = 0; s < SPW; ++s) {
          const int t = t0 + s, p = d - t;
          const bool on = t < nbk && p >= 0 && p < n;
          const unsigned long long v = cf[par][t];
          const float c = coef_c(v), sn = coef_s(v);
          const float lo = cr[s], hi = rw[s];
          const bool act = on && live && p < j;
          cr[s] = act ? rot_lo(c, sn, lo, hi) : lo;
          rw[s] = act ? rot_hi(c, sn, lo, hi) : hi;
          rws[t][lane] = rw[s];
          if (on && live && t == nbk - 1 && p <= j)
            R[(size_t)p * W + j] = p == j ? xd : cr[s];
        }
        GP(kGpApply)
        if (NW > 1) {
          if (q < NW - 1) crx[par ^ 1][q + 1][lane] = cr[SPW - 1];
          __syncthreads();
        }
        GP(kGpBarrier)
      }
    }
    __syncthreads();
  }
  GP_SAVE(blockIdx.x * NW + q)
}

// ---------------------------------------------------------------- G2 ----
// ---------------------------------------------------------------- G2 ----
// ---------------------------------------------------------------- G2 ----
// For i = m-2 down to `start`: (c, s) = rotation(v[i], v[i+1]) of the
// running vector (v[i] <- c v[i] - s v[i+1]), applied to rows (i, i+1) of
// X1 (m x n1) and X2 (m x n2), row strides n1 and n2.  *vout <- the final
// v[start].  v is read only.
__global__ void __launch_bounds__(kChainThreads)
chain_kernel(const float* __restrict__ v, float* __restrict__ X1, int n1,
             float* __restrict__ X2, int n2, int m, int start,
             float* __restrict__ vout) {
  extern __shared__ float sm[];
  __shared__ int ready;
  const int T = m - 1 - start;  // rotations
  float* sv = sm;               // v[start .. m-1]
  float* cc = sv + (m - start);
  float* ss = cc + max(T, 1);
  const int tid = threadIdx.x;
  for (int e = tid; e < m - start; e += kChainThreads) sv[e] = v[start + e];
  if (tid == 0) ready = 0;
  __syncthreads();

  if (tid < 32) {  // the coefficients, by lane 0
    if (tid == 0) {
      float carry = sv[m - 1 - start];
      for (int t = 0; t < T; ++t) {
        const float a = sv[m - 2 - t - start];
        float c, s;
        rotation(a, carry, c, s);
        cc[t] = c;
        ss[t] = s;
        carry = rot_lo(c, s, a, carry);
        if ((t + 1) % kChainPublish == 0 || t == T - 1) {
          __threadfence_block();
          *(volatile int*)&ready = t + 1;
        }
      }
      if (blockIdx.x == 0) *vout = carry;
    }
    return;
  }

  const int g = blockIdx.x * kChainCols + tid - 32;
  if (g >= n1 + n2) return;
  float* X = g < n1 ? X1 : X2;
  const int ld = g < n1 ? n1 : n2;
  const int j = g < n1 ? g : g - n1;
  float carry = X[(size_t)(m - 1) * ld + j];
  int known = 0;
  for (int t0 = 0; t0 < T; t0 += kChainBlock) {
    const int cnt = min(kChainBlock, T - t0);
    float x[kChainBlock];
#pragma unroll
    for (int u = 0; u < kChainBlock; ++u)
      if (u < cnt) x[u] = X[(size_t)(m - 2 - t0 - u) * ld + j];
    while (known < t0 + cnt) {
      known = *(volatile int*)&ready;
      if (known < t0 + cnt) __nanosleep(64);
    }
    __threadfence_block();
#pragma unroll
    for (int u = 0; u < kChainBlock; ++u) {
      if (u < cnt) {
        const int i = m - 2 - t0 - u;
        const float c = cc[t0 + u], s = ss[t0 + u];
        X[(size_t)(i + 1) * ld + j] = rot_hi(c, s, x[u], carry);
        carry = rot_lo(c, s, x[u], carry);
      }
    }
  }
  X[(size_t)start * ld + j] = carry;
}


// ---------------------------------------------------------------- G3 ----
// For i = 0 .. L-1, L = min(m - 1, nH): (c, s) = rotation(H[i, i],
// H[i+1, i]) of the current H, applied to rows (i, i+1) of H (m x nH) and
// Qt (m x nQ), row strides nH and nQ.  A CTA of `warps` warps (blockDim.x /
// 32) per 32 warps consecutive columns of [H | Qt], each warp on 32 of
// them, all stepping i in order; each lane carries its column's running
// row i and holds rows i + 1 .. i + kPf in registers (loaded kPf steps
// ahead).  With carry_j(i) the running H[i+1, j] after step i and P_j(i) =
// H[i+1, j] as it was (the hi row of step i):
//   coefficient i = rotation(rot_hi(c_{i-1}, s_{i-1}, carry_i(i-2),
//                                   P_i(i-1)), P_i(i)),
// so the warp of H column i makes it with every lane, from c_{i-1} (which
// every lane holds) and the three inputs that column i's lane shuffled to
// the warp at step i - 1, before its own rotation: nothing passes between
// lanes between two coefficients made here.  A warp steps in three loops,
// each with one source of coefficients and no branch between them: those
// of earlier CTAs (global memory, 32 words a load), those of earlier warps
// of its CTA (the CTA's table of self-flagging words), and its own.  No
// lane branches on whether its column still changes: the rotation is
// computed in every lane and kept, or stored, where it does.
__global__ void __launch_bounds__(32 * kHessMaxWarps)
hessenberg_kernel(float* __restrict__ H, int nH, float* __restrict__ Qt,
                  int nQ, int m, unsigned long long* __restrict__ coef,
                  int* abort) {
  __shared__ unsigned long long tab[32 * kHessMaxWarps];  // step i - cg0
  const unsigned full = 0xffffffffu;
  const int nw = blockDim.x / 32;
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int e = threadIdx.x; e < 32 * nw; e += blockDim.x) tab[e] = kSent;
  __syncthreads();
  const int cg0 = blockIdx.x * 32 * nw;  // the CTA's first column
  const int wg0 = cg0 + 32 * w;          // this warp's first column
  const int g = wg0 + lane;
  const int L = min(m - 1, nH);
  const bool live = g < nH + nQ;
  float* X = g < nH ? H + g : Qt + (g - nH);
  const size_t ld = g < nH ? nH : nQ;
  // The last step that changes this column: H column j is finished after
  // step j (zero below row j + 1), a column of Qt meets every step.
  const int last = !live ? -1 : (g < nH ? min(g, L - 1) : L - 1);
  int wlast = last;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    wlast = max(wlast, __shfl_xor_sync(full, wlast, o));
  // Xr: column g, or a column that exists, for the unconditional loads;
  // rlast: the last row they read (row last + 1, at least 0).
  const float* Xr = live ? X : (nH > 0 ? H : Qt);
  const int rlast = min(max(last + 1, 0), m - 1);
  float carry = Xr[0];
  float pf[kPf];  // at step i, pf[i % kPf] holds row i + 1
#pragma unroll
  for (int q = 0; q < kPf; ++q) pf[q] = Xr[min(q + 1, rlast) * ld];
  // Step i with (c, s), in slot u = i % kPf of the ring: the rotated rows
  // kept and stored where this column still changes, row i + 1 + kPf
  // loaded into the slot.
#define G3_APPLY(i, u, c, s)                                         \
  {                                                                  \
    const float hi = pf[u];                                          \
    const float lo2 = rot_lo(c, s, carry, hi);                       \
    const float hi2 = rot_hi(c, s, carry, hi);                       \
    const bool on = (i) <= last;                                     \
    if (on) X[(i) * ld] = lo2;                                       \
    if ((i) == last) X[((i) + 1) * ld] = hi2;                        \
    carry = on ? hi2 : carry;                                        \
    pf[u] = Xr[min((i) + 1 + kPf, rlast) * ld];                      \
  }
  GP_INIT
  // 1. Coefficients of earlier CTAs: 32 words a load, polled while the
  // next word is unwritten.
  const int enda = min(cg0, wlast + 1);
  unsigned long long batch = kSent;  // words bstart + lane
  int bstart = 0, bvalid = 0;
  for (int i0 = 0; i0 < enda; i0 += kPf) {
#pragma unroll
    for (int u = 0; u < kPf; ++u) {
      const int i = i0 + u;
      if (i >= enda) break;
      GP_STEP(false)
      if (i >= bstart + bvalid) {
        bstart = i;
        for (int spins = 0;; ++spins) {
          batch = i + lane < enda ? ld_word(coef + i + lane) : kSent;
          const unsigned ok = __ballot_sync(full, batch != kSent);
          bvalid = ok == full ? 32 : __ffs(~ok) - 1;
          if (bvalid > 0) break;
          const bool stop = lane == 0 && give_up(spins, abort);
          if (__shfl_sync(full, stop, 0)) {  // lane 0 decides
            batch = nan_word();
            bvalid = 32;
            break;
          }
          __nanosleep(64);
        }
      }
      const unsigned long long v = __shfl_sync(full, batch, i - bstart);
      GP(kGpWaitCta)
      G3_APPLY(i, u, coef_c(v), coef_s(v))
      GP(kGpApply)
    }
  }
  // 2. Coefficients of earlier warps of this CTA.
  const int endb = min(wg0, wlast + 1);
  for (int i0 = cg0; i0 < endb; i0 += kPf) {
#pragma unroll
    for (int u = 0; u < kPf; ++u) {
      const int i = i0 + u;
      if (i >= endb) break;
      GP_STEP(false)
      const unsigned long long v = get_shared(&tab[i - cg0], abort);
      GP(kGpWaitWarp)
      G3_APPLY(i, u, coef_c(v), coef_s(v))
      GP(kGpApply)
    }
  }
  // 3. This warp's own: every step of it up to wlast (a warp that holds
  // columns of Qt holds H's last column, so L - 1 < wg0 + 32).  The first
  // coefficient's inputs come from lane 0 (column wg0 after step wg0 - 1,
  // its row wg0 + 1); each step shuffles the next one's from its lane.
  if (wg0 <= wlast) {
    const float t0 = __shfl_sync(full, carry, 0);
    float ca = 0.f, cb = 0.f, cc = __shfl_sync(full, pf[0], 0);
    float pc = 1.f, ps = 0.f;
    for (int i0 = wg0; i0 <= wlast; i0 += kPf) {
#pragma unroll
      for (int u = 0; u < kPf; ++u) {
        const int i = i0 + u;
        if (i > wlast) break;
        GP_STEP(true)
        const int src = min(i + 1 - wg0, 31);
        const float na = __shfl_sync(full, carry, src);
        const float nb = __shfl_sync(full, pf[u], src);
        const float nc = __shfl_sync(full, pf[(u + 1) % kPf], src);
        GP(kGpHand)
        const float t = i == wg0 ? t0 : rot_hi(pc, ps, ca, cb);
        float c, s;
        rotation_sel(t, cc, c, s);
        GP(kGpMake)
        const unsigned long long v = pack(c, s);
        if (lane == 0) st_shared(&tab[i - cg0], v);
        st_word_if(lane == 0, coef + i, v);
        GP(kGpHand)
        G3_APPLY(i, u, c, s)
        ca = na;
        cb = nb;
        cc = nc;
        pc = c;
        ps = s;
        GP(kGpApply)
      }
    }
  }
#undef G3_APPLY
  GP_SAVE(blockIdx.x * nw + w)
}

// The most CTAs of `threads` threads and `smem` bytes of dynamic shared
// memory that the card keeps resident at once (a cooperative launch needs
// every CTA resident), asked of the runtime once for each kernel and size.
int max_resident(const void* kern, int threads, int smem) {
  struct Entry {
    const void* kern;
    int threads, smem, ctas;
  };
  static Entry cache[64];
  static int cached = 0;
  for (int e = 0; e < cached; ++e)
    if (cache[e].kern == kern && cache[e].threads == threads &&
        cache[e].smem == smem)
      return cache[e].ctas;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                    smem) != cudaSuccess)
    return 0;
  if (cached < 64) cache[cached++] = {kern, threads, smem, sms * per_sm};
  return sms * per_sm;
}

}  // namespace

extern "C" {

#ifdef MPBQR_GIVENS_PROF
// Copy the phase clocks (kGpWarps x kGpSlots signed 64-bit) to the host.
int mpbqr_givens_prof(long long* prof) {
  return (int)cudaMemcpyFromSymbol(prof, g_gv_prof, sizeof(g_gv_prof));
}
#endif

// G1: R (n x W, fp32, row-major, in place) with the k rows of `rows` (k x W)
// folded in, in blocks of `slots` rows (1, 2, 4, 8 or 16, at least min(k,
// 16); ops/kernels/givens.py::fold_layout): ceil(W / 32) CTAs of
// FoldShape<slots>::NW warps, launched cooperatively (every CTA resident:
// they wait on each other).  coef: ceil(k / 16) x (n + 16) x 16 words set
// to all ones by the caller (blocks of fewer rows use a part of theirs);
// *abort zero.  A layout the kernel does not take returns
// cudaErrorInvalidValue, one whose CTAs cannot all be resident
// cudaErrorCooperativeLaunchTooLarge, before any launch.
int mpbqr_givens_fold_rows(float* R, const float* rows, int n, int W, int k,
                           unsigned long long* coef, int* abort, int slots,
                           void* stream) {
  const void* kern = slots == 16  ? (const void*)fold_rows_kernel<16>
                     : slots == 8 ? (const void*)fold_rows_kernel<8>
                     : slots == 4 ? (const void*)fold_rows_kernel<4>
                     : slots == 2 ? (const void*)fold_rows_kernel<2>
                     : slots == 1 ? (const void*)fold_rows_kernel<1>
                                  : nullptr;
  if (kern == nullptr || slots < (k < kSlots ? k : kSlots))
    return (int)cudaErrorInvalidValue;
  const int warps = slots > 4 ? slots / 4 : 1;  // FoldShape<slots>::NW
  const int ctas = (W + 31) / 32;
  if (ctas > max_resident(kern, 32 * warps, 0))
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&R, &rows, &n, &W, &k, &coef, &abort};
  cudaError_t err = cudaLaunchCooperativeKernel(
      kern, dim3(ctas), dim3(32 * warps), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// G2: rows start..m-1 of X1 (m x n1) and X2 (m x n2) rotated in place by the
// bottom-up chain of v (m, read only); *vout <- the rotated v[start].
// ceil((n1 + n2) / 96) CTAs of 128 threads, `smem_bytes` of dynamic shared
// memory each (ops/kernels/givens.py::chain_smem).
int mpbqr_givens_chain(const float* v, float* X1, int n1, float* X2, int n2,
                       int m, int start, float* vout, int smem_bytes,
                       void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int ctas = (n1 + n2 + kChainCols - 1) / kChainCols;
  chain_kernel<<<ctas, kChainThreads, smem_bytes, (cudaStream_t)stream>>>(
      v, X1, n1, X2, n2, m, start, vout);
  return (int)cudaGetLastError();
}

// G3: H (m x nH) re-triangularized and Qt (m x nQ) rotated with it, in
// place: ceil(ceil((nH + nQ) / 32) / warps) CTAs of `warps` <= 8 warps,
// each warp on 32 columns of [H | Qt], launched cooperatively
// (ops/kernels/givens.py::hessenberg_layout gives warps).  coef:
// max(min(m - 1, nH), 1) words set to all ones by the caller; *abort zero.
// Errors as for G1.
int mpbqr_givens_hessenberg(float* H, int nH, float* Qt, int nQ, int m,
                            unsigned long long* coef, int* abort, int warps,
                            void* stream) {
  if (warps < 1 || warps > kHessMaxWarps) return (int)cudaErrorInvalidValue;
  const void* kern = (const void*)hessenberg_kernel;
  const int ctas = ((nH + nQ + 31) / 32 + warps - 1) / warps;
  if (ctas > max_resident(kern, 32 * warps, 0))
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&H, &nH, &Qt, &nQ, &m, &coef, &abort};
  cudaError_t err = cudaLaunchCooperativeKernel(
      kern, dim3(ctas), dim3(32 * warps), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
