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
// C entry point that issues a fixed sequence of kernels per panel j:
//   * the Gram P^T P (gemm_tn of panel.cuh: one launch, its K split over
//     the CTAs of thread-block clusters that add their tiles in rank order);
//   * the device NS chain of ns_chain.cuh (one thread-block cluster);
//   * Q = P X, written in place into the panel's columns (gemm_nt: a CTA
//     owns whole rows);
//   * t = triu(X^T G) straight into Rg's diagonal block;
//   * the eager projection G1 = Qj^T C into Rg's row block and C -= Qj G1,
//     split by columns: the narrow part, panel j+1's r columns, on the
//     critical stream right after Q_j, and the wide part, every later
//     column, on a second stream from an event recorded after panel j+1's
//     Gram (so after Q_j), so that it runs under panel j+1's chain and
//     Q = P X;
//   * for robust panels, the three-pass chain of _tri_ns_panel(robust=True),
//     spilling Q1 / Q2 through scratch panels.
// What bounds it: the r x r chains are latency-bound on one cluster (~0.1
// ms each at r = 128); the products are tens to hundreds of MFLOP each
// (with the bf16 flags on the tensor cores), bounded by fill and latency.
// Critical path: per panel the Gram, the chain, Q = P X and the narrow
// projection; ~78% of the products' work (the wide projection) runs beside
// it.
// Streams: the critical stream has the card's highest priority and the
// wide stream its lowest, and a wide part becomes ready together with the
// chain it runs under, so the block scheduler places the chain's cluster
// first instead of waiting for wide CTAs to drain.  Both streams are made
// once per device (non-blocking, so the legacy default stream does not
// serialize them) with their events, and the entry joins them back into
// the caller's stream before it returns, so scratch the caller took on its
// stream is safe.  They are shared by every call on the device: one host
// thread at a time may call the entries on a device.
// Ordering: the narrow projection of panel j+1 waits for the wide part of
// panel j, which updated its columns; every column block sees its updates
// in panel order, so every output element has the same sum in the same
// order as in one stream.  Built with -DMPBQR_GROUP_SERIAL (a probe-only
// build, utils/group_probe.py --serial), the same kernels run in program
// order on the caller's stream.
// K5's scrub adds two products over the m x p prefix of previous Q on the
// critical stream before the group body (p grows to n - g r: at p = w =
// 1024, m = 2048 they are 8.6 GFLOP).
// Widths: any r from 1 to kMaxWidth.  The chain runs with the layout the
// caller passes (ops/kernels/ns.py::ns_layout: shared memory up to 128, the
// L2 route beyond, its operands in this entry's scratch), the combine with
// its own rule; above 128 the in-place Q = P X first copies the panel to
// scratch (panel.cuh, "Widths").
// Batches (mpbqr_bgs_group_batched; the TPU kernel under jax.vmap, its
// grid gaining the batch axis): B groups of one shape run the same
// sequence of launches as one group, each launch over the B members
// (products: the member folded into the grid's x; the chain and the
// combine: one cluster or CTA set a member, blockIdx.y; the worst
// residual: one CTA a member), with one scratch a member.  The streams
// and events order whole batched launches.  The layout is the stack's
// (ops/kernels/ns.py::group_layout for B members): at r = 128 or 256 it
// selects the stack route, whose products are stack_gemm.cu's Hopper
// kernels (TMA-fed, bf16 on wgmma), laid out by the B members' tiles, at
// r = 128 each narrow projection one cluster launch a member
// (stack_proj); otherwise panel.cuh's products split by the members'
// tiles.  Every
// output element's sum has a fixed order whatever the batch, so a member
// gets the bits of a one-member call at the stack's layout.
#include "panel.cuh"
#include "stack_gemm.h"

namespace mpbqr {

// Member blockIdx.x's worst = max(0, resid[0], ..., resid[g-1]) (its
// residuals `stride` floats past member 0's), NaN-propagating.
__global__ void worst_resid(const float* resid, int g, float* worst,
                            long long stride) {
  if (threadIdx.x == 0) {
    resid += blockIdx.x * stride;
    float w = 0.f;
    for (int j = 0; j < g; ++j) w = nan_max(w, resid[j]);
    worst[blockIdx.x] = w;
  }
}

// The scratch of an entry for B members, piece by piece: each piece holds
// the B members' copies one after another, member b at b times the
// piece's stride (rr: r x r; mr: m x r; rp: g residuals rounded up to 32;
// ch: the L2 chain's operands; cb: the L2 combine's), so that one batched
// launch reads every member's at one stride, and the staging copy of
// several column blocks (Q = P X above r = 128) is one 2-D copy of B m
// rows.
struct GroupScratch {
  float *G, *X1, *X2, *X3, *T1, *T2, *T3, *tmpA, *tmpB, *resid, *chain,
      *comb;
  long long rr, mr, rp, ch, cb;
};

static long long group_scratch_floats(int m, int r, int g, GroupScratch* s,
                                      float* base, int B = 1) {
  GroupScratch dummy;
  GroupScratch* d = s ? s : &dummy;
  d->rr = (long long)r * r;
  d->mr = (long long)m * r;
  d->rp = ((g + 31) / 32) * 32;
  d->ch = chain_inst(r) ? 0 : chain_l2_scratch_floats(r);
  d->cb = combine_scratch_floats(r);
  long long off = 0;
  auto take = [&](float** p, long long n) {
    if (s) *p = base + off;
    off += n * B;
  };
  take(&d->G, d->rr);
  take(&d->X1, d->rr);
  take(&d->X2, d->rr);
  take(&d->X3, d->rr);
  take(&d->T1, d->rr);
  take(&d->T2, d->rr);
  take(&d->T3, d->rr);
  take(&d->tmpA, d->mr);
  take(&d->tmpB, d->mr);
  take(&d->resid, d->rp);
  // The L2 kernels' tensor maps start on 16 bytes: the chain's scratch
  // here, and the combine's after it (the chain's is whole 16-byte
  // pieces).
  off = (off + 3) / 4 * 4;
  take(&d->chain, d->ch);
  take(&d->comb, d->cb);
  return off;
}

constexpr int kMaxDevices = 64;

// The streams and events of one entry: the critical and wide streams, and
// the events that order them (entry, Q_j written, wide part done, exit).
struct GroupStreams {
  cudaStream_t crit = nullptr, wide = nullptr;
  cudaEvent_t in = nullptr, q = nullptr, done = nullptr, out = nullptr;
};

// The current device's streams and events, made at its first call.
static cudaError_t group_streams(GroupStreams** out) {
  static GroupStreams per_device[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  GroupStreams& s = per_device[dev];
  if (s.crit == nullptr) {
    int least = 0, greatest = 0;
    err = cudaDeviceGetStreamPriorityRange(&least, &greatest);
    if (err != cudaSuccess) return err;
    GroupStreams made;
    err = cudaStreamCreateWithPriority(&made.crit, cudaStreamNonBlocking,
                                       greatest);
    if (err == cudaSuccess)
      err = cudaStreamCreateWithPriority(&made.wide, cudaStreamNonBlocking,
                                         least);
    for (cudaEvent_t* e : {&made.in, &made.q, &made.done, &made.out})
      if (err == cudaSuccess)
        err = cudaEventCreateWithFlags(e, cudaEventDisableTiming);
    if (err != cudaSuccess) return err;
    s = made;
  }
  *out = &s;
  return cudaSuccess;
}

// Where one entry's kernels go: the critical and wide streams and their
// events, or (serial, -DMPBQR_GROUP_SERIAL) the caller's stream for both.
struct Sched {
  cudaStream_t caller, crit, wide;
  GroupStreams* gs;
  bool serial;
  bool wide_pending;

  cudaError_t begin(cudaStream_t st) {
    caller = crit = wide = st;
    gs = nullptr;
    wide_pending = false;
#ifdef MPBQR_GROUP_SERIAL
    serial = true;
    return cudaSuccess;
#else
    serial = false;
    cudaError_t err = group_streams(&gs);
    if (err != cudaSuccess) return err;
    crit = gs->crit;
    wide = gs->wide;
    err = cudaEventRecord(gs->in, caller);
    if (err != cudaSuccess) return err;
    return cudaStreamWaitEvent(crit, gs->in, 0);
#endif
  }
  // Before the narrow projection: wait for the wide part of the previous
  // panel (the latest record of `done`).
  cudaError_t wait_wide() {
    if (serial || !wide_pending) return cudaSuccess;
    return cudaStreamWaitEvent(crit, gs->done, 0);
  }
  // The point on the critical stream after which the next wide part may
  // run (recorded before the chain is launched, waited on after it).
  cudaError_t mark() {
    return serial ? cudaSuccess : cudaEventRecord(gs->q, crit);
  }
  cudaError_t fork() {
    return serial ? cudaSuccess : cudaStreamWaitEvent(wide, gs->q, 0);
  }
  cudaError_t wide_done() {
    if (serial) return cudaSuccess;
    wide_pending = true;
    return cudaEventRecord(gs->done, wide);
  }
  // Join the wide stream into the critical one, and that into the caller's.
  cudaError_t end() {
    if (serial) return cudaSuccess;
    cudaError_t err = wait_wide();
    if (err != cudaSuccess) return err;
    err = cudaEventRecord(gs->out, crit);
    if (err != cudaSuccess) return err;
    return cudaStreamWaitEvent(caller, gs->out, 0);
  }
};

#define MPBQR_TRY(x)                        \
  do {                                      \
    const cudaError_t e_ = (x);             \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)

// The group body on Q (B members of m x g*r, already scrubbed against
// previous groups, factored in place; member b's Q and Rg b m w and b w w
// floats past member 0's, its worst at worst[b]): per panel the Gram, the
// chain(s), Q = P X, t into Rg's diagonal block and the projection of the
// later columns, narrow on the critical stream and wide beside it; then
// the worst residual.  Every kernel is one launch for the B members, in
// the same sequence as for one.  Rg must be zeroed first (on sc.crit).
// Returns the first CUDA error met.
static int group_body(Sched& sc, float* Q, float* Rg, float* worst,
                      const GroupScratch& s, int m, int r, int g,
                      const int* iters, const int* robust, bool bd, bool bg,
                      bool chain_mid, const ProductLayout& lay,
                      const KernelLayout& cl, int B = 1) {
  const int w = g * r;
  const long long sq = (long long)m * w, srg = (long long)w * w;
  const cudaStream_t st = sc.crit;
  const bool stk = lay.route == kStackRoute;
  // The group buffer and the two scratch panels, B members each.
  const StackBuf qb{Q, m, w, sq}, ab{s.tmpA, m, r, s.mr},
      bb{s.tmpB, m, r, s.mr};
  auto mid = [&](int it) {
    return chain_mid ? std::max(0, it - kMidFinal) : 0;
  };
  // The Gram of columns [c, c + r) of buffer b into s.G.
  auto gram = [&](const StackBuf& b, int c) -> cudaError_t {
    if (stk)
      return stack_tn(st, bg, r, r, m, b, c, b, c, s.G, r, s.rr, lay.split,
                      lay.chunk, B);
    const float* P = b.p + c;
    return tn(st, bg, r, r, m, P, b.cols, P, b.cols, s.G, r, lay.split,
              lay.chunk, Members{B, b.stride, b.stride, s.rr});
  };
  // Columns [c, c + r) of buffer b times X into Qo (leading dimension ldo,
  // member stride so; in place when Qo is those columns).
  auto qprod = [&](const StackBuf& b, int c, const float* X, float* Qo,
                   int ldo, long long so) -> cudaError_t {
    if (stk)
      return stack_nt(st, bg, m, r, r, b, c, StackBuf{X, r, r, s.rr}, 0, 0,
                      Qo, ldo, so, false, lay.bm_panel, B);
    return nt(st, bg, m, r, r, b.p + c, b.cols, X, r, Qo, ldo, false,
              lay.bm_panel, lay.bn, Members{B, b.stride, s.rr, so});
  };
  // The projection of panel c0's columns out of the n columns at cc, on
  // stream ss: G1 (in Rg, leading dimension w) = Qk^T C, then C -= Qk G1
  // with bm rows per CTA; on the stack route at r = 128 the narrow one (the
  // next panel's columns) in one launch when the split's chunks are whole
  // 128-row tiles (ns.py::stack_fused_narrow).
  const bool fuse = stk && r == kStackTile && lay.chunk % kStackTile == 0;
  auto project = [&](cudaStream_t ss, int c0, int cc, int n, float* G1,
                     int bm, bool narrow) -> cudaError_t {
    cudaError_t err;
    if (fuse && narrow)
      return stack_proj(ss, bd, m, qb, c0, cc, G1, w, srg, lay.split,
                        lay.chunk, B);
    if (stk) {
      err = stack_tn(ss, bd, r, n, m, qb, c0, qb, cc, G1, w, srg, lay.split,
                     lay.chunk, B);
      if (err == cudaSuccess)
        err = stack_nt(ss, bd, m, n, r, qb, c0, StackBuf{Rg, w, w, srg}, c0,
                       cc, Q + cc, w, sq, true, bm, B);
      return err;
    }
    err = tn(ss, bd, r, n, m, Q + c0, w, Q + cc, w, G1, w, lay.split,
             lay.chunk, Members{B, sq, sq, srg});
    if (err == cudaSuccess)
      err = nt(ss, bd, m, n, r, Q + c0, w, G1, w, Q + cc, w, true, bm,
               lay.bn, Members{B, sq, srg, sq});
    return err;
  };
  // The chain on s.G into X and t (leading dimension ldt, member stride
  // stt), its residual into res.
  auto chain = [&](float* X, float* t, int ldt, long long stt, float* res,
                   int it, float shift, int refine, int mid_it, int omega,
                   int triu_t, int mode) {
    return launch_chain(r, cl, s.chain, st, s.G, X, t, ldt, res, it, shift,
                        refine, mid_it, omega, 1, triu_t, mode, B,
                        ChainBatch{s.rr, s.rr, stt, s.rp, s.ch});
  };
  // Panel k's wide part: G1 = Qk^T C and C -= Qk G1 over the columns
  // after panel k+1's, on the wide stream from the last mark().
  auto wide = [&](int k) -> cudaError_t {
    const int c0 = k * r;
    cudaError_t err = sc.fork();
    if (err == cudaSuccess)
      err = project(sc.wide, c0, c0 + 2 * r, w - c0 - 2 * r,
                    Rg + (size_t)c0 * w + c0 + 2 * r, lay.bm_wide, false);
    if (err == cudaSuccess) err = sc.wide_done();
    return err;
  };
  int pending = -1;  // the panel whose wide part is still to be issued
  for (int j = 0; j < g; ++j) {
    const int c0 = j * r;
    float* Pj = Q + c0;
    float* Rjj = Rg + (size_t)c0 * w + c0;
    MPBQR_TRY(gram(qb, c0));
    // The previous panel's wide part runs from this Gram on, under this
    // panel's chain, which is issued first and has the critical stream's
    // priority: its cluster is placed before the wide CTAs.
    if (pending >= 0) MPBQR_TRY(sc.mark());
    if (!robust[j]) {
      MPBQR_TRY(chain(s.X1, Rjj, w, srg, s.resid + j, iters[j], 0.f, 0,
                      mid(iters[j]), 1, 1, RESID_SQUARE));
    } else {
      // Pass 1: shifted Gram (condition capped), t1 = X1^T Gs in full.
      MPBQR_TRY(chain(s.X1, s.T1, r, s.rr, s.resid + j, kRobustIt1, 1e-3f, 0,
                      mid(kRobustIt1), 0, 0, RESID_RAW));
    }
    if (pending >= 0) MPBQR_TRY(wide(pending));
    pending = -1;
    if (!robust[j]) {
      if (lay.bn >= r) {
        MPBQR_TRY(qprod(qb, c0, s.X1, Pj, w, sq));
      } else {  // several column blocks: not in place
        // The B members' m rows are B m rows of pitch w (and r in tmpA).
        MPBQR_TRY(cudaMemcpy2DAsync(s.tmpA, sizeof(float) * r, Pj,
                                    sizeof(float) * w, sizeof(float) * r,
                                    (size_t)m * B, cudaMemcpyDeviceToDevice,
                                    st));
        MPBQR_TRY(qprod(ab, 0, s.X1, Pj, w, sq));
      }
    } else {
      MPBQR_TRY(qprod(qb, c0, s.X1, s.tmpA, r, s.mr));
      MPBQR_TRY(gram(ab, 0));
      // Pass 2 on the fresh Gram of Q1, t2 = X2^T M1 in full.
      MPBQR_TRY(chain(s.X2, s.T2, r, s.rr, s.resid + j, kRobustIt2, 0.f, 0,
                      mid(kRobustIt2), 0, 0, RESID_RAW));
      MPBQR_TRY(qprod(ab, 0, s.X2, s.tmpB, r, s.mr));
      MPBQR_TRY(gram(bb, 0));
      // Pass 3: identity-seeded refine with the exact final residual.
      MPBQR_TRY(chain(s.X3, s.T3, r, s.rr, s.resid + j, kRobustIt3, 0.f, 1, 0,
                      1, 0, RESID_SCALE));
      MPBQR_TRY(qprod(bb, 0, s.X3, Pj, w, sq));
      MPBQR_TRY(launch_combine(r, combine_layout(r, cl.ctas), st, s.T1,
                               s.T2, s.T3, Rjj, w, s.comb, B,
                               CombineBatch{s.rr, srg}));
    }
    if (j + 1 == g) break;
    // The narrow part, panel j+1's columns, after the wide part of panel
    // j-1 that updated them; panel j's wide part waits for the next Gram.
    MPBQR_TRY(sc.wait_wide());
    MPBQR_TRY(project(st, c0, c0 + r, r, Rjj + r, lay.bm_panel, true));
    if (w - c0 - 2 * r > 0) pending = j;
  }
  worst_resid<<<B, 32, 0, st>>>(s.resid, g, worst, s.rp);
  MPBQR_TRY(cudaGetLastError());
  return (int)sc.end();
}

}  // namespace mpbqr

extern "C" {

// Floats of global scratch that mpbqr_bgs_group needs.
long long mpbqr_bgs_group_scratch_floats(int m, int r, int g) {
  return mpbqr::group_scratch_floats(m, r, g, nullptr, nullptr);
}

// Floats of global scratch that mpbqr_bgs_group_batched needs for B
// members (B times one member's).
long long mpbqr_bgs_group_batched_scratch_floats(int B, int m, int r, int g) {
  return mpbqr::group_scratch_floats(m, r, g, nullptr, nullptr, B);
}

// The batched K2: B groups of one shape, the same iters / robust / flags,
// as ONE sequence of launches (the single group's sequence, each launch
// over the B members; the two streams order whole batched launches).  P
// and Q (B x m x g*r, Q may equal P), Rg (B x g*r x g*r) contiguous,
// member b at b m g r (b (g r)^2) floats; worst B floats; `scratch` holds
// mpbqr_bgs_group_batched_scratch_floats(B, m, r, g).  The layout is
// group_layout(m, r, ..., members=B, g) with its product route
// (kPanelRoute or kStackRoute) after bn; whatever B, member b's outputs
// are bit for bit those of this entry at B = 1 on its group at the same
// layout (at kPanelRoute: those of mpbqr_bgs_group).  Returns
// cudaErrorInvalidValue for a B outside 1 .. 65535 or a layout or route
// the kernels do not take, else as mpbqr_bgs_group.
int mpbqr_bgs_group_batched(const float* P, float* Q, float* Rg, float* worst,
                            float* scratch, int B, int m, int r, int g,
                            const int* iters, const int* robust,
                            int bf16_dots, int bf16_gram, int chain_mid,
                            int split, int chunk, int bm_panel, int bm_wide,
                            int bn, int product_route, int inst, int route,
                            int ctas, int chain_scratch, int chain_smem,
                            void* stream) {
  using namespace mpbqr;
  const ProductLayout lay{split,   chunk, bm_panel,
                          bm_wide, bn,    product_route};
  const KernelLayout cl{inst, route, ctas, chain_scratch, chain_smem};
  if (!product_layout_ok(m, r, lay) || !chain_layout_ok(r, cl) || B < 1 ||
      B > kMaxBatch)
    return (int)cudaErrorInvalidValue;
  const size_t w = (size_t)g * r;
  GroupScratch s;
  group_scratch_floats(m, r, g, &s, scratch, B);
  Sched sc;
  MPBQR_TRY(sc.begin((cudaStream_t)stream));
  if (Q != P)
    MPBQR_TRY(cudaMemcpyAsync(Q, P, sizeof(float) * B * m * w,
                              cudaMemcpyDeviceToDevice, sc.crit));
  MPBQR_TRY(cudaMemsetAsync(Rg, 0, sizeof(float) * B * w * w, sc.crit));
  return group_body(sc, Q, Rg, worst, s, m, r, g, iters, robust,
                    bf16_dots != 0, bf16_gram != 0, chain_mid != 0, lay, cl,
                    B);
}

// P (m x g*r, fp32, row-major, read only) -> Q (m x g*r, may equal P),
// Rg (g*r x g*r, block upper) and *worst (one float), all device pointers.
// iters[j] / robust[j] are host arrays of g entries.  bf16_gram rounds the
// Gram and Q = P X operands to bf16, bf16_dots the projection operands;
// chain_mid runs the early chain iterations with bf16-split products.
// split, chunk, bm_panel, bm_wide, bn and the chain's inst, route, ctas,
// scratch_floats, smem_bytes: the layout of ops/kernels/ns.py::
// group_layout(m, r, ...).  The kernels run on the entry's own streams,
// joined into `stream` before it returns.  Returns the first CUDA error
// met, or cudaErrorInvalidValue for an r outside 1 .. kMaxWidth or a
// layout the products or the chain do not run.  The batched entry's B = 1.
int mpbqr_bgs_group(const float* P, float* Q, float* Rg, float* worst,
                    float* scratch, int m, int r, int g, const int* iters,
                    const int* robust, int bf16_dots, int bf16_gram,
                    int chain_mid, int split, int chunk, int bm_panel,
                    int bm_wide, int bn, int inst, int route, int ctas,
                    int chain_scratch, int chain_smem, void* stream) {
  return mpbqr_bgs_group_batched(P, Q, Rg, worst, scratch, 1, m, r, g, iters,
                                 robust, bf16_dots, bf16_gram, chain_mid,
                                 split, chunk, bm_panel, bm_wide, bn,
                                 mpbqr::kPanelRoute, inst, route, ctas,
                                 chain_scratch, chain_smem, stream);
}

// K5.  P (m x g*r, fp32, raw columns, read only) and Qprev (m x p, leading
// dimension ldq, fp32 or bf16 per qprev_bf16: the strided prefix of the
// driver's Q buffer is read in place, bf16 widened on load) -> Q (m x g*r),
// Rprev (p x g*r) = Qprev^T P, Rg and *worst as in mpbqr_bgs_group.
// The scrub is block-classical: all of C2 comes from the raw P (one
// gemm_tn over m, split by scrub_split / scrub_chunk of ops/kernels/ns.py::
// tn_split(p, g*r, m)), then one subtracting product Q -= Qprev C2 in
// place on the group buffer, with gemm_nt's wide tile.  With bf16_dots
// both products round their operands to bf16 as they stage them (the
// second one rounds C2 as it reads it); Rprev keeps the unrounded fp32 C2.
int mpbqr_bgs_group_proj(const float* P, const void* Qprev, int ldq,
                         int qprev_bf16, int p, float* Q, float* Rprev,
                         float* Rg, float* worst, float* scratch, int m,
                         int r, int g, const int* iters, const int* robust,
                         int bf16_dots, int bf16_gram, int chain_mid,
                         int split, int chunk, int bm_panel, int bm_wide,
                         int bn, int inst, int route, int ctas,
                         int chain_scratch, int chain_smem, int scrub_split,
                         int scrub_chunk, void* stream) {
  using namespace mpbqr;
  const ProductLayout lay{split, chunk, bm_panel, bm_wide, bn};
  const KernelLayout cl{inst, route, ctas, chain_scratch, chain_smem};
  if (!product_layout_ok(m, r, lay) || !chain_layout_ok(r, cl))
    return (int)cudaErrorInvalidValue;
  if (p < 1 || ldq < p) return (int)cudaErrorInvalidValue;
  if (scrub_split < 1 || scrub_split > kTnMaxSplit || scrub_chunk < 1 ||
      (long long)scrub_split * scrub_chunk < m ||
      (long long)(scrub_split - 1) * scrub_chunk >= m)
    return (int)cudaErrorInvalidValue;
  const int w = g * r;
  GroupScratch s;
  group_scratch_floats(m, r, g, &s, scratch);
  Sched sc;
  MPBQR_TRY(sc.begin((cudaStream_t)stream));
  const cudaStream_t st = sc.crit;
  MPBQR_TRY(cudaMemcpyAsync(Q, P, sizeof(float) * (size_t)m * w,
                            cudaMemcpyDeviceToDevice, st));
  MPBQR_TRY(cudaMemsetAsync(Rg, 0, sizeof(float) * (size_t)w * w, st));
  const bool bd = bf16_dots != 0;
  auto scrub = [&](auto* Qp) -> cudaError_t {
    cudaError_t err = tn(st, bd, p, w, m, Qp, ldq, Q, w, Rprev, w,
                         scrub_split, scrub_chunk);
    if (err != cudaSuccess) return err;
    return nt(st, bd, m, w, p, Qp, ldq, Rprev, w, Q, w, true, lay.bm_wide,
              lay.bn);
  };
  MPBQR_TRY(qprev_bf16 ? scrub(static_cast<const __nv_bfloat16*>(Qprev))
                       : scrub(static_cast<const float*>(Qprev)));
  return group_body(sc, Q, Rg, worst, s, m, r, g, iters, robust, bd,
                    bf16_gram != 0, chain_mid != 0, lay, cl);
}

// One product of the group's kinds, alone on `stream`, for the probe
// (utils/group_probe.py): C = A^T B (ta) with gemm_tn's split / chunk, or
// C = A B / C -= A B (sub) with gemm_nt's (bm, bn) tile; A fp32 or bf16
// (a_bf16); bf16 rounds the operands and runs on the tensor cores.
int mpbqr_group_product(int ta, int bf16, int M, int N, int K,
                        const void* A, int lda, int a_bf16, const float* B,
                        int ldb, float* C, int ldc, int sub, int split,
                        int chunk, int bm, int bn, void* stream) {
  using namespace mpbqr;
  const cudaStream_t st = (cudaStream_t)stream;
  auto run = [&](auto* Ap) -> cudaError_t {
    if (ta)
      return tn(st, bf16 != 0, M, N, K, Ap, lda, B, ldb, C, ldc, split,
                chunk);
    return nt(st, bf16 != 0, M, N, K, Ap, lda, B, ldb, C, ldc, sub != 0, bm,
              bn);
  };
  return (int)(a_bf16 ? run(static_cast<const __nv_bfloat16*>(A))
                      : run(static_cast<const float*>(A)));
}

}  // extern "C"
