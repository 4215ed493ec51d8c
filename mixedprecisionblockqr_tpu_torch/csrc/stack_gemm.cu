// The panel products of K2 over a batch, laid out by the stack and written
// for Hopper: the stack route of mpbqr_bgs_group_batched (bgs_group.cu),
// chosen by ops/kernels/ns.py::group_layout for B > 1 members of width
// r = 128 or 256.  Every other caller keeps panel.cuh's gemm_tn / gemm_nt.
//
// Replaces, with panel.cuh, the products inside
// mixedprecisionblockqr_tpu/ops/pallas/ns.py::bgs_group_fused
// (_bgs_group_kernel: the Grams, Q = P X and the in-group projections) as
// the JAX package runs it under jax.vmap (ops/blockqr.py::block_qr_batched
// -> _block_qr_bgs).
//
// What bounds them: at 8 x 2048 x 128 a stacked Gram reads 8.4 MB and does
// 0.54 GFLOP, 2.5 us of HBM time and 0.5 us of bf16 tensor-core time, so
// the bytes and the latency of reaching them set the time.  panel.cuh's
// kernels run a stack with the single group's 32 x 32 tiles (1,024 CTAs a
// Gram, each operand column block read four times from L2) and stage
// through registers.  Here:
//   * stack_tn (C = A^T B over the long K = m: the Grams and G1 = Q^T C):
//     one CTA a 128 x 128 output tile (a member's whole r = 128 Gram) over
//     one chunk of K; the `split` chunks of a tile are the CTAs of one
//     cluster, which add their tiles over distributed shared memory in
//     rank order.  A Gram's operand tile is loaded once for both sides.
//   * stack_nt (C (-)= A B over the short K = r: Q = P X, the updates): a
//     CTA owns whole 128-row tiles of one 128-column block, as many as the
//     stack's layout gives it (ns.py::_stack_rows: the members' tiles on
//     at most one CTA an SM); B (X or G1, K x 128) comes first through the
//     ring and stays in shared memory for all the CTA's tiles.
// Both take their fp32 operand tiles through a ring of 3-4 stages filled
// by TMA (cp.async.bulk.tensor.3d: columns, rows, member; one producer
// thread; full / empty mbarriers), so no consumer thread issues a global
// load in the loop.  TMA zero-fills past a buffer's rows.
// Arithmetic: under the bf16 flags the consumers round each fp32 stage to
// bf16 (nearest even, as bf16_round / mm_bf16) into a 128B-swizzled
// K-major tile (the transpose of stack_tn's operands happens on this
// pass), then two warpgroups run wgmma.mma_async m64n128k16 with fp32
// accumulators in registers; each bf16 x bf16 product is exact in fp32.
// Otherwise (Precision.HIGHEST) the same 256 threads run true fp32 FMA on
// an 8 x 8 register tile each, never TF32 or a bf16 split.
// Bits: every output element's sum runs in one fixed order (K stages
// ascending, cluster ranks ascending), whatever the members around it, so
// two launches agree bit for bit and a member of a stack gets the bits of
// a one-member launch at the stack's layout.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <stdint.h>

#include <algorithm>

#include "stack_gemm.h"

namespace cg = cooperative_groups;

namespace mpbqr {
namespace {

constexpr int kT = 128;                 // output tile (rows and columns)
constexpr int kK = 64;                  // rows of K (tn) / k (nt) a stage
constexpr int kConsumers = 256;         // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer's warp
constexpr int kTileBytes = kT * kK * 4;    // one fp32 stage tile: 32 KB
constexpr int kHalfBytes = kT * kK * 2;    // one bf16 [128][64] tile: 16 KB
constexpr int kMaxSplit = 8;
constexpr int kMaxK = 256;              // stack_nt's K
constexpr int kSmemMax = 232448;        // a CTA's shared memory on an H100
constexpr int kMaxMembers = 65535;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Spin until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// One box of a 3-D map (columns c0, rows c1, member c2) into shared memory.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
// The consumers' own barrier (the producer's warp never joins it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}
// Shared-memory writes of this thread become visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a 128B-swizzled K-major bf16 operand: rows of 128 bytes
// (64 k), 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d += A (64 x 16) B (16 x 128), both K-major in shared memory.
__device__ __forceinline__ void wgmma_kk(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// k = 8 kc .. 8 kc + 7 of row `row` of a [128][64] bf16 tile, rounded to
// nearest even, into its 16-byte chunk: chunk kc of the row's 128 bytes,
// XOR-ed with row % 8 (the 128B swizzle; the tile 1024-byte aligned).
__device__ __forceinline__ void st_chunk(uint32_t tile, int row, int kc,
                                         const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  const uint32_t addr = tile + row * 128 + ((kc ^ (row & 7)) << 4);
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
               : "memory");
}

// A fp32 stage [64 k][128 columns] into the K-major bf16 tile [128][64]:
// thread t takes column t % 128 and chunks t / 128, + 2, + 4, + 6.
__device__ __forceinline__ void convert_transposed(uint32_t tile,
                                                   const float* src, int t) {
  const int c = t & (kT - 1);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int kc = (t >> 7) + 2 * q;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = src[(kc * 8 + i) * kT + c];
    st_chunk(tile, c, kc, v);
  }
}

// A fp32 stage [128 rows][64 k] into the K-major bf16 tile [128][64]:
// thread t takes chunk t % 8 of rows t / 8, + 32, + 64, + 96.
__device__ __forceinline__ void convert_rows(uint32_t tile, const float* src,
                                             int t) {
  const int kc = t & 7;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = (t >> 3) + 32 * q;
    const float4 a = *reinterpret_cast<const float4*>(src + row * kK + kc * 8);
    const float4 b =
        *reinterpret_cast<const float4*>(src + row * kK + kc * 8 + 4);
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    st_chunk(tile, row, kc, v);
  }
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// The fp32 register tile of consumer thread t: rows (a < 4 ? 4 ty + a :
// 64 + 4 ty + a - 4), columns likewise from tx, ty = t / 16, tx = t % 16.
__device__ __forceinline__ int reg_idx(int a, int q) {
  return a < 4 ? 4 * q + a : 64 + 4 * q + a - 4;
}

// Where consumer thread t's accumulator d[4 j + h] of a wgmma tile lies:
// warpgroup t / 128 owns rows 64 (t / 128) .. + 63.
__device__ __forceinline__ void frag_pos(int t, int j, int h, int& row,
                                         int& col) {
  const int wg = t >> 7, warp = (t & 127) >> 5, g = (t & 31) >> 2,
            q = t & 3;
  row = wg * 64 + warp * 16 + g + ((h & 2) ? 8 : 0);
  col = 8 * j + 2 * q + (h & 1);
}

// -- pieces shared by the kernels ---------------------------------------------

// A ring of fp32 stages filled by the producer thread: stage s at base +
// s * bytes, its barriers `full` at bars + 8 s and `empty` at bars + 8 (n +
// s).  Each thread walks its own copy in the same order.
struct Ring {
  uint32_t base, bars;
  int n, bytes;
  int stage;
  uint32_t phase;
  __device__ uint32_t full() const { return bars + 8 * stage; }
  __device__ uint32_t empty() const { return bars + 8 * (n + stage); }
  __device__ uint32_t slot() const { return base + stage * bytes; }
  __device__ void next() {
    if (++stage == n) {
      stage = 0;
      phase ^= 1;
    }
  }
  // Thread 0: the barriers, released by one arrival (bf16: thread 0 once
  // the stage is converted) or by one a consumer warp (fp32).
  __device__ void init(bool bf) const {
    for (int s = 0; s < n; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (n + s), bf ? 1 : kConsumers / 32);
    }
  }
};

__device__ __forceinline__ Ring make_ring(uint32_t base, uint32_t bars,
                                          int n, int bytes) {
  return Ring{base, bars, n, bytes, 0, 0u};
}

// The producer: the next stage's box of `map` at (c0, c1, member c2).
__device__ __forceinline__ void produce(Ring& rg, const CUtensorMap* map,
                                        uint32_t off, int c0, int c1, int c2,
                                        bool first, int bytes) {
  if (first) {
    mbar_wait(rg.empty(), rg.phase ^ 1);
    mbar_expect_tx(rg.full(), bytes);
  }
  tma_load_3d(rg.slot() + off, map, rg.full(), c0, c1, c2);
}

// A consumer thread is done with the ring's current stage.
template <bool BF>
__device__ __forceinline__ void release(Ring& rg, int t) {
  if constexpr (BF) {
    if (t == 0) mbar_arrive(rg.empty());  // after a consumers_sync
  } else {
    __syncwarp();
    if ((t & 31) == 0) mbar_arrive(rg.empty());
  }
  rg.next();
}

// The consumers' part of C = A^T B over nst stages of rg (A's [64 rows]
// [128 columns] box, then B's unless `same`), summed into d stage after
// stage: bf16 tiles tA / tB (tB = tA when `same`) on wgmma, or fp32 FMA.
template <bool BF>
__device__ __forceinline__ void tn_loop(float (&d)[64], Ring& rg, int nst,
                                        bool same, const char* gbase,
                                        uint32_t base, uint32_t tA,
                                        uint32_t tB, int t) {
  const int ty = t >> 4, tx = t & 15, wg = t >> 7;
  for (int s = 0; s < nst; ++s) {
    mbar_wait(rg.full(), rg.phase);
    const float* fa = reinterpret_cast<const float*>(gbase + (rg.slot() - base));
    const float* fb = same ? fa : fa + kT * kK;
    if constexpr (BF) {
      consumers_sync();  // both warpgroups are done with the last tiles
      convert_transposed(tA, fa, t);
      if (!same) convert_transposed(tB, fb, t);
      fence_async_smem();
      consumers_sync();
      release<BF>(rg, t);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kK / 16; ++ks)
        wgmma_kk(d, kmajor_desc(tA + wg * 64 * 128 + ks * 32),
                 kmajor_desc(tB + ks * 32));
      wgmma_commit_wait();
    } else {
#pragma unroll 4
      for (int k = 0; k < kK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(fa + k * kT + 4 * ty);
        const float4 a1 =
            *reinterpret_cast<const float4*>(fa + k * kT + 64 + 4 * ty);
        const float4 b0 = *reinterpret_cast<const float4*>(fb + k * kT + 4 * tx);
        const float4 b1 =
            *reinterpret_cast<const float4*>(fb + k * kT + 64 + 4 * tx);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b)
            d[a * 8 + b] = fmaf(av[a], bv[b], d[a * 8 + b]);
      }
      release<BF>(rg, t);
    }
  }
}

// Consumer thread t's 128 x 128 tile values: put(row, col, v) for each.
template <bool BF, typename F>
__device__ __forceinline__ void each_value(const float (&d)[64], int t,
                                           F&& put) {
  if constexpr (BF) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        int row, col;
        frag_pos(t, j, h, row, col);
        put(row, col, d[4 * j + h]);
      }
  } else {
    const int ty = t >> 4, tx = t & 15;
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b)
        put(reg_idx(a, ty), reg_idx(b, tx), d[a * 8 + b]);
  }
}

// The S partial 128 x 128 tiles at `red` in the cluster's CTAs, added in
// rank order: rank q finishes the float4s [q P, (q + 1) P) of the tile (P
// = 4096 / S) and hands each sum to out(e, v).  Every thread of every CTA
// calls it after writing its partial tile; it ends with a cluster barrier
// only if `last`, so a caller may still exchange before its CTAs leave.
template <typename F>
__device__ __forceinline__ void cluster_reduce(float* red, int S, int t,
                                               F&& out) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int q = (int)cluster.block_rank();
  const int per = kT * kT / 4 / S;
  for (int e = q * per + t; e < (q + 1) * per; e += kThreads) {
    float4 v = *cluster.map_shared_rank(reinterpret_cast<float4*>(red) + e, 0);
    for (int p = 1; p < S; ++p) {
      const float4 u =
          *cluster.map_shared_rank(reinterpret_cast<float4*>(red) + e, p);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    out(e, v);
  }
  cluster.sync();  // no CTA reuses its tile while another reads it
}

// Where consumer thread t's output i of a tile lies: the pair (j, h / 2)
// of the wgmma fragment (two columns, i = 2 j + h / 2) or the 4-column
// group (a, bq) of the register tile (i = 2 a + bq); its values are d[kW i
// .. kW i + kW - 1].
template <bool BF>
__device__ __forceinline__ void out_pos(int t, int i, int& row, int& col) {
  if constexpr (BF) {
    frag_pos(t, i >> 1, (i & 1) * 2, row, col);
  } else {
    row = reg_idx(i >> 1, t >> 4);
    col = reg_idx(4 * (i & 1), t & 15);
  }
}

// One 128-row tile of C (-)= A B, rows r0.., columns j0..: A's nkb stages
// of rg ([128 rows][64 k] boxes) against B's block in shared memory (bf16:
// xs, K-major [128][64] tiles; fp32: xf [K][128]); with SUB, C's values
// are read before the tile's stages under bf16 (their latency hides under
// the stages), after them under fp32 (whose register tile leaves no room
// for them).  wide: C's rows take 8-byte (bf16) / 16-byte (fp32) accesses.
template <bool BF, bool SUB>
__device__ __forceinline__ void nt_tile(Ring& rg, int nkb, const char* gbase,
                                        uint32_t base, uint32_t tA,
                                        uint32_t xs, const float* xf,
                                        float* C, int ldc, int M, int N,
                                        int r0, int j0, bool wide, int t) {
  constexpr int kOut = BF ? 32 : 16;  // outputs a thread
  constexpr int kW = BF ? 2 : 4;      // their width
  const int ty = t >> 4, tx = t & 15, wg = t >> 7;
  constexpr bool kEarly = SUB && BF;
  float cv[kEarly ? 64 : 1];
  if constexpr (kEarly) {
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      int row, col;
      out_pos<BF>(t, i, row, col);
      row += r0;
      col += j0;
      const float* p = C + (long long)row * ldc + col;
      if (row < M && wide && col + kW - 1 < N) {
        if constexpr (BF) {
          const float2 v = *reinterpret_cast<const float2*>(p);
          cv[2 * i] = v.x;
          cv[2 * i + 1] = v.y;
        } else {
          const float4 v = *reinterpret_cast<const float4*>(p);
          cv[4 * i] = v.x;
          cv[4 * i + 1] = v.y;
          cv[4 * i + 2] = v.z;
          cv[4 * i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < kW; ++c)
          cv[kW * i + c] = row < M && col + c < N ? p[c] : 0.f;
      }
    }
  }
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int kk = 0; kk < nkb; ++kk) {
    mbar_wait(rg.full(), rg.phase);
    const float* fa = reinterpret_cast<const float*>(gbase + (rg.slot() - base));
    if constexpr (BF) {
      consumers_sync();  // both warpgroups are done with the last tile
      convert_rows(tA, fa, t);
      fence_async_smem();
      consumers_sync();
      release<BF>(rg, t);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kK / 16; ++ks)
        wgmma_kk(d, kmajor_desc(tA + wg * 64 * 128 + ks * 32),
                 kmajor_desc(xs + kk * kHalfBytes + ks * 32));
      wgmma_commit_wait();
    } else {
#pragma unroll 2
      for (int k4 = 0; k4 < kK / 4; ++k4) {
        float4 fr[8];
#pragma unroll
        for (int a = 0; a < 8; ++a)
          fr[a] =
              *reinterpret_cast<const float4*>(fa + reg_idx(a, ty) * kK + 4 * k4);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float* brow = xf + (kk * kK + 4 * k4 + c) * kT;
          const float4 b0 = *reinterpret_cast<const float4*>(brow + 4 * tx);
          const float4 b1 = *reinterpret_cast<const float4*>(brow + 64 + 4 * tx);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            const float av = comp(fr[a], c);
#pragma unroll
            for (int b = 0; b < 8; ++b)
              d[a * 8 + b] = fmaf(av, bv[b], d[a * 8 + b]);
          }
        }
      }
      release<BF>(rg, t);
    }
  }
  // Every row of the tile has been read (all its stages consumed).
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    int row, col;
    out_pos<BF>(t, i, row, col);
    row += r0;
    col += j0;
    if (row >= M) continue;
    float v[kW];
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      v[c] = d[kW * i + c];
      if constexpr (kEarly) v[c] = cv[kW * i + c] - v[c];
    }
    float* p = C + (long long)row * ldc + col;
    if (wide && col + kW - 1 < N) {
      if constexpr (BF) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
      } else {
        if constexpr (SUB) {
          const float4 c4 = *reinterpret_cast<const float4*>(p);
          v[0] = c4.x - v[0];
          v[1] = c4.y - v[1];
          v[2] = c4.z - v[2];
          v[3] = c4.w - v[3];
        }
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < kW; ++c)
        if (col + c < N) p[c] = SUB && !kEarly ? p[c] - v[c] : v[c];
    }
  }
}

// -- stack_tn: C = A^T B ------------------------------------------------------

// grid (members x xt, ceil(M / 128), split), cluster (1, 1, split).  Stage
// s holds A's [64 rows][128 columns] box at (a_col + i0, kb + 64 s) and,
// unless `same` (a Gram: one box serves both sides), B's after it.
template <bool BF>
__global__ void __launch_bounds__(kThreads, 1)
stack_tn_kernel(const __grid_constant__ CUtensorMap mapA,
                const __grid_constant__ CUtensorMap mapB, int same, int M,
                int N, int K, int a_col, int b_col, float* C, int ldc,
                long long sc, int chunk, int xt, int stages) {
  extern __shared__ char raw[];
  const uint32_t raw_u = smem_u32(raw);
  const uint32_t base = (raw_u + 1023u) & ~1023u;
  char* gbase = raw + (base - raw_u);
  const int stage_bytes = (same ? 1 : 2) * kTileBytes;
  const uint32_t tA = base + stages * stage_bytes;
  const uint32_t tB = same ? tA : tA + kHalfBytes;
  Ring rg = make_ring(base, tA + (BF ? 2 * kHalfBytes : 0), stages,
                      stage_bytes);

  const int t = threadIdx.x;
  const int mb = (int)blockIdx.x / xt;
  const int i0 = blockIdx.y * kT, j0 = ((int)blockIdx.x - mb * xt) * kT;
  const int kb = blockIdx.z * chunk;
  const int nst = (min(K, kb + chunk) - kb + kK - 1) / kK;

  if (t == 0) {
    rg.init(BF);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  if (t == kConsumers) {  // producer
    for (int s = 0; s < nst; ++s) {
      produce(rg, &mapA, 0, a_col + i0, kb + s * kK, mb, true, stage_bytes);
      if (!same)
        produce(rg, &mapB, kTileBytes, b_col + j0, kb + s * kK, mb, false,
                0);
      rg.next();
    }
  } else if (t < kConsumers) {
    tn_loop<BF>(d, rg, nst, same, gbase, base, tA, tB, t);
  }

  float* Cm = C + mb * sc;
  const int S = (int)gridDim.z;
  if (S == 1) {
    if (t < kConsumers)
      each_value<BF>(d, t, [&](int row, int col, float v) {
        if (i0 + row < M && j0 + col < N)
          Cm[(long long)(i0 + row) * ldc + j0 + col] = v;
      });
    return;
  }
  __syncthreads();  // every stage consumed: the ring holds the partial tile
  float* red = reinterpret_cast<float*>(gbase);
  if (t < kConsumers)
    each_value<BF>(d, t, [&](int row, int col, float v) {
      red[row * kT + col] = v;
    });
  cluster_reduce(red, S, t, [&](int e, float4 v) {
    const int row = i0 + e / (kT / 4), col = j0 + (e % (kT / 4)) * 4;
    if (row >= M) return;
    float* out = Cm + (long long)row * ldc + col;
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col + c < N) out[c] = vv[c];
  });
}

// -- stack_nt: C (-)= A B -----------------------------------------------------

// grid (members x xt, ceil(M / rows_per_cta)).  The first K / 64 stages
// hold B's [64 rows][128 columns] boxes at (b_col + j0, b_row + 64 kb),
// which the consumers keep (bf16: K-major [128][64] tiles; fp32: [K][128]);
// then stage (tile, kk) holds A's [128 rows][64 k] box at (a_col + 64 kk,
// 128 tile).  vec: bit 0, C's rows take 8-byte accesses; bit 1, 16-byte.
template <bool BF, bool SUB>
__global__ void __launch_bounds__(kThreads, 1)
stack_nt_kernel(const __grid_constant__ CUtensorMap mapA,
                const __grid_constant__ CUtensorMap mapB, int M, int N, int K,
                int a_col, int b_row, int b_col, float* C, int ldc,
                long long sc, int rows_per_cta, int xt, int stages, int vec) {
  extern __shared__ char raw[];
  const uint32_t raw_u = smem_u32(raw);
  const uint32_t base = (raw_u + 1023u) & ~1023u;
  char* gbase = raw + (base - raw_u);
  const int nkb = K / kK;
  const uint32_t xs = base + stages * kTileBytes;  // B's block
  const int xbytes = BF ? nkb * kHalfBytes : K * kT * 4;
  const uint32_t tA = xs + xbytes;                 // A's bf16 tile (BF)
  Ring rg = make_ring(base, tA + (BF ? kHalfBytes : 0), stages, kTileBytes);

  const int t = threadIdx.x;
  const int mb = (int)blockIdx.x / xt;
  const int j0 = ((int)blockIdx.x - mb * xt) * kT;
  const int per = rows_per_cta / kT;
  const int first = blockIdx.y * per;
  const int last = min((M + kT - 1) / kT, first + per);
  C += mb * sc;

  if (t == 0) {
    rg.init(BF);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (t >= kConsumers) {
    if (t == kConsumers) {  // producer
      for (int kb = 0; kb < nkb; ++kb) {
        produce(rg, &mapB, 0, b_col + j0, b_row + kb * kK, mb, true,
                kTileBytes);
        rg.next();
      }
      for (int tile = first; tile < last; ++tile)
        for (int kk = 0; kk < nkb; ++kk) {
          produce(rg, &mapA, 0, a_col + kk * kK, tile * kT, mb, true,
                  kTileBytes);
          rg.next();
        }
    }
    return;
  }

  // B's block (columns beyond N only feed outputs that are not written).
  float* xf = reinterpret_cast<float*>(gbase + (xs - base));
  for (int kb = 0; kb < nkb; ++kb) {
    mbar_wait(rg.full(), rg.phase);
    const float* fb = reinterpret_cast<const float*>(gbase + (rg.slot() - base));
    if constexpr (BF) {
      convert_transposed(xs + kb * kHalfBytes, fb, t);
      consumers_sync();  // every thread is done reading the stage
    } else {
      float4* dst = reinterpret_cast<float4*>(xf + kb * kK * kT);
      for (int e = t; e < kK * kT / 4; e += kConsumers)
        dst[e] = reinterpret_cast<const float4*>(fb)[e];
    }
    release<BF>(rg, t);
  }
  if constexpr (BF) fence_async_smem();
  consumers_sync();

  const bool wide = (vec & (BF ? 1 : 2)) != 0;
  for (int tile = first; tile < last; ++tile)
    nt_tile<BF, SUB>(rg, nkb, gbase, base, tA, xs, xf, C, ldc, M, N,
                     tile * kT, j0, wide, t);
}

// -- stack_proj: G1 = P^T C, then C -= P G1, one cluster a member -------------

// The narrow projection of a panel step at r = 128 in one launch: P the
// columns [p_col, p_col + 128) and C the columns [c_col, c_col + 128) of
// Q's m rows, G1 into G (ldg, member stride sg).  grid (split, members),
// cluster (split, 1, 1).  Rank q sums G1's products over rows [q chunk,
// (q + 1) chunk) as stack_tn does (two-operand stages of mapT's [64 rows]
// [128 columns] boxes, ring1), the cluster adds the partial tiles in rank
// order (rank q writes its share of G1 to G and pushes it into every CTA's
// copy `fin`), then each CTA updates the same rows of C as stack_nt does
// (G1 from `fin`; P's [128 rows][64 k] boxes of mapN through ring3, which
// reuses ring1's memory), so no second launch reads G1 back.  chunk is a
// whole number of 128-row tiles.  Shared memory: the rings (128 KB), fin
// (64 KB) and, with bf16, the converted tiles (32 KB; G1's K-major form in
// phase 3, whose A tile takes fin's place once G1 is converted).
template <bool BF>
__global__ void __launch_bounds__(kThreads, 1)
stack_proj_kernel(const __grid_constant__ CUtensorMap mapT,
                  const __grid_constant__ CUtensorMap mapN, int M, int p_col,
                  int c_col, float* Q, int ldq, long long sq, float* G,
                  int ldg, long long sg, int chunk, int vec) {
  extern __shared__ char raw[];
  const uint32_t raw_u = smem_u32(raw);
  const uint32_t base = (raw_u + 1023u) & ~1023u;
  char* gbase = raw + (base - raw_u);
  const uint32_t fin_u = base + 4 * kTileBytes;     // after the rings
  const uint32_t tAB = fin_u + 2 * kTileBytes;      // bf16 tiles (BF)
  const uint32_t bars = tAB + (BF ? 2 * kHalfBytes : 0);
  Ring r1 = make_ring(base, bars, 2, 2 * kTileBytes);
  Ring r3 = make_ring(base, bars + 8 * 4, 4, kTileBytes);
  float* fin = reinterpret_cast<float*>(gbase + (fin_u - base));

  const int t = threadIdx.x;
  const int S = (int)gridDim.x, mb = blockIdx.y;
  const int kb = blockIdx.x * chunk, ke = min(M, kb + chunk);
  const int nst = (ke - kb + kK - 1) / kK;

  if (t == 0) {
    r1.init(BF);
    r3.init(BF);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Phase 1: this CTA's rows of G1 = P^T C.
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  if (t == kConsumers) {
    for (int s = 0; s < nst; ++s) {
      produce(r1, &mapT, 0, p_col, kb + s * kK, mb, true, 2 * kTileBytes);
      produce(r1, &mapT, kTileBytes, c_col, kb + s * kK, mb, false, 0);
      r1.next();
    }
  } else if (t < kConsumers) {
    tn_loop<BF>(d, r1, nst, false, gbase, base, tAB, tAB + kHalfBytes, t);
  }

  // Phase 2: G1 added in rank order, to G and into every CTA's fin.
  __syncthreads();  // every stage consumed: the ring holds the partial tile
  float* red = reinterpret_cast<float*>(gbase);
  if (t < kConsumers)
    each_value<BF>(d, t, [&](int row, int col, float v) {
      red[row * kT + col] = v;
    });
  fence_async_smem();  // phase 3's TMA writes this memory again
  float* Gm = G + mb * sg;
  cluster_reduce(red, S, t, [&](int e, float4 v) {
    const int row = e / (kT / 4), col = (e % (kT / 4)) * 4;
    *reinterpret_cast<float4*>(Gm + (long long)row * ldg + col) = v;
    cg::cluster_group cluster = cg::this_cluster();
    for (int p = 0; p < S; ++p)
      *cluster.map_shared_rank(reinterpret_cast<float4*>(fin) + e, p) = v;
  });  // its closing barrier: every CTA holds all of G1

  // Phase 3: C -= P G1 over this CTA's rows, in 128-row tiles.
  const int first = kb / kT, last = (ke + kT - 1) / kT;
  float* Qm = Q + mb * sq;
  if (t == kConsumers) {
    for (int tile = first; tile < last; ++tile)
      for (int kk = 0; kk < 2; ++kk) {
        produce(r3, &mapN, 0, p_col + kk * kK, tile * kT, mb, true,
                kTileBytes);
        r3.next();
      }
  }
  if (t >= kConsumers) return;
  if constexpr (BF) {
    convert_transposed(tAB, fin, t);
    convert_transposed(tAB + kHalfBytes, fin + kK * kT, t);
    fence_async_smem();
  }
  consumers_sync();
  const bool wide = (vec & (BF ? 1 : 2)) != 0;
  for (int tile = first; tile < last; ++tile)
    nt_tile<BF, true>(r3, 2, gbase, base, fin_u, tAB, fin, Qm + c_col, ldq,
                      M, kT, tile * kT, 0, wide, t);
}

// -- host -------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the process has already
// loaded (as tiled_matmul.cu finds it); nullptr if it cannot be found.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (h)
      fn = reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// The tensor maps of one (buffer, members, box), made at first use: a
// group call takes the same few maps for all its panels, and the next call
// on the same buffers takes them again, so the host encodes each once.
struct MapKey {
  const void* p;
  int rows, cols, members, box_cols, box_rows;
  long long stride;
  bool operator==(const MapKey& o) const {
    return p == o.p && rows == o.rows && cols == o.cols &&
           members == o.members && box_cols == o.box_cols &&
           box_rows == o.box_rows && stride == o.stride;
  }
};
constexpr int kMapCache = 64;

// The 3-D map (columns, rows, member) of `b`'s `members` members with a
// box of box_cols x box_rows x 1, unswizzled fp32, zero beyond the buffer;
// false when the driver refuses it (a base or a stride off 16 bytes).
bool stack_map(const StackBuf& b, int members, int box_cols, int box_rows,
               CUtensorMap* out) {
  static MapKey keys[kMapCache];
  static CUtensorMap maps[kMapCache];
  static int filled = 0, next = 0;
  const MapKey key{b.p, b.rows, b.cols, members, box_cols, box_rows, b.stride};
  for (int i = 0; i < filled; ++i)
    if (keys[i] == key) {
      *out = maps[i];
      return true;
    }
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)b.cols, (cuuint64_t)b.rows,
                              (cuuint64_t)members};
  const cuuint64_t strides[2] = {(cuuint64_t)b.cols * 4,
                                 (cuuint64_t)b.stride * 4};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUtensorMap map;
  if (fn(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(b.p),
         dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  keys[next] = key;
  maps[next] = map;
  next = (next + 1) % kMapCache;
  if (filled < kMapCache) ++filled;
  *out = map;
  return true;
}

// Whether `b` is a buffer the maps describe for `members` members: a
// 16-byte-aligned base, rows of whole 16-byte units, a member stride of
// whole 16-byte units that holds a member's rows.
bool buf_ok(const StackBuf& b, int members) {
  return b.p != nullptr && b.rows >= 1 && b.cols >= 1 && b.cols % 4 == 0 &&
         reinterpret_cast<uintptr_t>(b.p) % 16 == 0 &&
         (members == 1 || (b.stride % 4 == 0 &&
                           b.stride >= (long long)b.rows * b.cols));
}

// A member stride the map takes for one member (any multiple of 16 bytes).
StackBuf one_member(StackBuf b, int members) {
  if (members == 1) b.stride = (long long)b.rows * b.cols;
  return b;
}

constexpr int kMaxDevices = 64;

// Lets `kern` take kSmemMax bytes of dynamic shared memory on the current
// device, once per device (`done` one flag a device).
template <typename Kern>
cudaError_t allow_smem(Kern kern, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

}  // namespace

cudaError_t stack_tn(cudaStream_t st, bool bf, int M, int N, int K,
                     const StackBuf& A0, int a_col, const StackBuf& B0,
                     int b_col, float* C, int ldc, long long sc, int split,
                     int chunk, int members) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const StackBuf A = one_member(A0, members), B = one_member(B0, members);
  if (members < 1 || members > kMaxMembers || split < 1 ||
      split > kMaxSplit || chunk < kK || chunk % kK != 0 ||
      (long long)split * chunk < K || (long long)(split - 1) * chunk >= K ||
      K != A.rows || K != B.rows || !buf_ok(A, members) ||
      !buf_ok(B, members) || a_col < 0 || b_col < 0 || a_col + M > A.cols ||
      b_col + N > B.cols || C == nullptr || ldc < N)
    return cudaErrorInvalidValue;
  const bool same = A.p == B.p && a_col == b_col && A.cols == B.cols &&
                    A.stride == B.stride && M <= kT && N <= kT;
  CUtensorMap mapA, mapB;
  if (!stack_map(A, members, kT, kK, &mapA) ||
      !stack_map(B, members, kT, kK, &mapB))
    return cudaErrorInvalidValue;
  const int stages = same ? 4 : 3;
  const int smem = 1024 + stages * (same ? 1 : 2) * kTileBytes +
                   (bf ? 2 * kHalfBytes : 0) + 2 * stages * 8;
  static bool allowed[2][kMaxDevices] = {};
  const cudaError_t err = bf ? allow_smem(stack_tn_kernel<true>, allowed[1])
                             : allow_smem(stack_tn_kernel<false>, allowed[0]);
  if (err != cudaSuccess) return err;
  const int xt = (N + kT - 1) / kT;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(xt * members, (M + kT - 1) / kT, split);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int sm = same ? 1 : 0;
  return bf ? cudaLaunchKernelEx(&cfg, stack_tn_kernel<true>, mapA, mapB, sm,
                                 M, N, K, a_col, b_col, C, ldc, sc, chunk, xt,
                                 stages)
            : cudaLaunchKernelEx(&cfg, stack_tn_kernel<false>, mapA, mapB,
                                 sm, M, N, K, a_col, b_col, C, ldc, sc, chunk,
                                 xt, stages);
}

cudaError_t stack_nt(cudaStream_t st, bool bf, int M, int N, int K,
                     const StackBuf& A0, int a_col, const StackBuf& B0,
                     int b_row, int b_col, float* C, int ldc, long long sc,
                     bool sub, int rows_per_cta, int members) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const StackBuf A = one_member(A0, members), B = one_member(B0, members);
  if (members < 1 || members > kMaxMembers || K < kK || K > kMaxK ||
      K % kK != 0 || rows_per_cta < kT || rows_per_cta % kT != 0 ||
      M != A.rows || !buf_ok(A, members) || !buf_ok(B, members) ||
      a_col < 0 || a_col + K > A.cols || b_row < 0 || b_row + K > B.rows ||
      b_col < 0 || b_col + N > B.cols || C == nullptr || ldc < N ||
      (M + rows_per_cta - 1) / rows_per_cta > 65535)
    return cudaErrorInvalidValue;
  CUtensorMap mapA, mapB;
  if (!stack_map(A, members, kK, kT, &mapA) ||
      !stack_map(B, members, kT, kK, &mapB))
    return cudaErrorInvalidValue;
  const int xbytes = bf ? (K / kK) * kHalfBytes : K * kT * 4;
  const int fixed = 1024 + xbytes + (bf ? kHalfBytes : 0);
  const int stages = std::min(4, (kSmemMax - fixed - 64) / kTileBytes);
  if (stages < 2) return cudaErrorInvalidValue;
  const int smem = fixed + stages * kTileBytes + 2 * stages * 8;
  auto kern = bf ? (sub ? stack_nt_kernel<true, true>
                        : stack_nt_kernel<true, false>)
                 : (sub ? stack_nt_kernel<false, true>
                        : stack_nt_kernel<false, false>);
  static bool allowed[4][kMaxDevices] = {};
  const cudaError_t err = allow_smem(kern, allowed[2 * bf + sub]);
  if (err != cudaSuccess) return err;
  const uintptr_t cp = reinterpret_cast<uintptr_t>(C);
  const int vec = (ldc % 2 == 0 && sc % 2 == 0 && cp % 8 == 0 ? 1 : 0) |
                  (ldc % 4 == 0 && sc % 4 == 0 && cp % 16 == 0 ? 2 : 0);
  const int xt = (N + kT - 1) / kT;
  const dim3 grid(xt * members, (M + rows_per_cta - 1) / rows_per_cta, 1);
  kern<<<grid, kThreads, smem, st>>>(mapA, mapB, M, N, K, a_col, b_row,
                                     b_col, C, ldc, sc, rows_per_cta, xt,
                                     stages, vec);
  return cudaGetLastError();
}

cudaError_t stack_proj(cudaStream_t st, bool bf, int M, const StackBuf& Q0,
                       int p_col, int c_col, float* G, int ldg, long long sg,
                       int split, int chunk, int members) {
  if (M <= 0) return cudaSuccess;
  const StackBuf Q = one_member(Q0, members);
  const uintptr_t gp = reinterpret_cast<uintptr_t>(G);
  if (members < 1 || members > kMaxMembers || split < 1 ||
      split > kMaxSplit || chunk < kT || chunk % kT != 0 ||
      (long long)split * chunk < M || (long long)(split - 1) * chunk >= M ||
      M != Q.rows || !buf_ok(Q, members) || p_col < 0 || c_col < 0 ||
      p_col + kT > Q.cols || c_col + kT > Q.cols || G == nullptr ||
      gp % 16 != 0 || ldg < kT || ldg % 4 != 0 ||
      (members > 1 && sg % 4 != 0))
    return cudaErrorInvalidValue;
  CUtensorMap mapT, mapN;
  if (!stack_map(Q, members, kT, kK, &mapT) ||
      !stack_map(Q, members, kK, kT, &mapN))
    return cudaErrorInvalidValue;
  const int smem = 1024 + 6 * kTileBytes + (bf ? 2 * kHalfBytes : 0) + 12 * 8;
  auto kern = bf ? stack_proj_kernel<true> : stack_proj_kernel<false>;
  static bool allowed[2][kMaxDevices] = {};
  const cudaError_t err = allow_smem(kern, allowed[bf]);
  if (err != cudaSuccess) return err;
  float* C = const_cast<float*>(Q.p) + c_col;
  const uintptr_t cp = reinterpret_cast<uintptr_t>(C);
  const int vec = (Q.cols % 2 == 0 && Q.stride % 2 == 0 && cp % 8 == 0 ? 1 : 0) |
                  (Q.cols % 4 == 0 && Q.stride % 4 == 0 && cp % 16 == 0 ? 2 : 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, members, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, mapT, mapN, M, p_col, c_col,
                            const_cast<float*>(Q.p), Q.cols, Q.stride, G, ldg,
                            sg, chunk, vec);
}

}  // namespace mpbqr

extern "C" {

// One stacked product alone on `stream`, for the probes: with ta == 2
// the fused narrow projection (stack_proj: G1 = A_p^T A_c into C, A_c -=
// A_p G1, p = a_col, c = b_col, M = N = 128, K = a_rows); C = A^T B (ta;
// A's columns [a_col, a_col + M) and B's [b_col, b_col + N) over their
// a_rows rows) with stack_tn's split / chunk, or C (-)= A B (sub; A's
// columns [a_col, a_col + K) over its a_rows rows, B's columns [b_col,
// b_col + N) of its K rows of b_cols) with stack_nt's rows per CTA; each
// operand `members` deep at its member stride.  Returns the launch's
// error.
int mpbqr_stack_product(int ta, int bf16, int members, int M, int N, int K,
                        const float* A, int a_rows, int a_cols, long long sa,
                        int a_col, const float* B, int b_cols, long long sb,
                        int b_col, float* C, int ldc, long long sc, int sub,
                        int split, int chunk, int rows_per_cta, void* stream) {
  using namespace mpbqr;
  const cudaStream_t st = (cudaStream_t)stream;
  const StackBuf a{A, a_rows, a_cols, sa};
  if (ta == 2)  // the fused narrow projection, in place on A's columns
    return M == kT && N == kT && K == a_rows
               ? (int)stack_proj(st, bf16 != 0, a_rows, a, a_col, b_col, C,
                                 ldc, sc, split, chunk, members)
               : (int)cudaErrorInvalidValue;
  if (ta)
    return (int)stack_tn(st, bf16 != 0, M, N, K, a, a_col,
                         StackBuf{B, a_rows, b_cols, sb}, b_col, C, ldc, sc,
                         split, chunk, members);
  return (int)stack_nt(st, bf16 != 0, M, N, K, a, a_col,
                       StackBuf{B, K, b_cols, sb}, 0, b_col, C, ldc, sc,
                       sub != 0, rows_per_cta, members);
}

}  // extern "C"
