// Tall-panel pieces shared by bgs_group.cu (K2, K5) and panel_qr.cu (K3): the
// two panel products with their launch helpers, the robust three-pass
// R-block combine and the panel chain schedule.
//
// The products of a panel factorization (Grams, Q = P X, the projections
// and K5's scrub) stay inside this repository's sources, as the TPU kernels
// compute them in their own body.  Two kernels cover them, each in two
// arithmetic forms chosen per call:
//   * gemm_tn: C = A^T B with the long K (m) as the summed index: the Grams
//     and G1 = Q^T C.  A CTA computes one 32 x 32 output tile over one chunk
//     of K rows; its four warps take interleaved 16-row slices of every
//     64-row stage and sum their partial tiles in warp order through shared
//     memory.  The `split` chunks of one tile are the CTAs of one
//     thread-block cluster along z, which add their tiles over distributed
//     shared memory in rank order: one launch, no float atomics, no global
//     partials, and the same bits every run.  The split is chosen in Python
//     (ops/kernels/ns.py::tn_split) so that an r x r product runs on ~128
//     CTAs.  Every element's sum has the same order whatever the tile's
//     place, so a product split by output columns into two launches gives
//     the bits of one launch.
//   * gemm_nt: C = A B or C -= A B with the short K (r, or K5's p) summed in
//     32-deep stages, k ascending.  A CTA owns BM whole rows of a BN-wide
//     column block; with BN covering all of N a CTA reads only the rows it
//     writes, and reads them all before it writes, so Q = P X runs in place
//     on the group buffer.
// Arithmetic: with bf16 operands asked for (bf16_dots / bf16_gram) both
// operands are rounded to bf16 to nearest-even while they are staged into
// shared memory (the same rounding as bf16_round and mm_bf16) and the
// product runs on the tensor cores: mma.sync m16n8k16 bf16 -> fp32 fed by
// ldmatrix (.trans for the k-major operands).  Each bf16 x bf16 product is
// exact in fp32; only the order of the fp32 sum differs from an FMA loop.
// Otherwise (Precision.HIGHEST) the product is true fp32 FMA on the CUDA
// cores, never TF32 and never a bf16 split.  Stages are double-buffered
// through registers (the next stage's loads are in flight while the current
// one is multiplied): cp.async cannot convert fp32 to bf16 on the way in.
// What bounds them: at r <= 128 each product is tens to hundreds of MFLOP,
// below a microsecond at the bf16 rate, so launch latency and fill set
// their time; their ~128-CTA grids keep the card's SMs busy while they run.
// Widths: both products take any M, N, K (ragged edges predicated, the
// 16-byte loads only on aligned rows), so a panel of any r runs them.
// gemm_nt's column tile is the chain's instantiation (32, 64, 128) for r
// <= 128, and 128 beyond, where an r-wide product spans ceil(r / 128)
// column blocks: Q = P X then no longer runs in place (a CTA would read
// rows that another block of its columns has already written), so the
// group stages the panel into scratch first (bgs_group.cu).
#pragma once

#include <algorithm>
#include <type_traits>

#include "ns_chain.cuh"

namespace mpbqr {

constexpr int kGemmThreads = 128;  // four warps
constexpr int kTnTile = 32;        // gemm_tn: square output tile
constexpr int kTnStage = 64;       // gemm_tn: K rows per stage (16 a warp)
constexpr int kTnMaxSplit = 8;     // gemm_tn: CTAs of one cluster
constexpr int kNtDepth = 32;       // gemm_nt: K per stage
// Chain schedule of a panel, the same constants as ops/kernels/ns.py
// (MID_FINAL, ROBUST_ITERS): with chain_mid, all but the final kMidFinal
// iterations of a non-refine chain run the bf16-split products; robust
// panels run passes of kRobustIt1 / kRobustIt2 / kRobustIt3 iterations.
constexpr int kMidFinal = 2;
constexpr int kRobustIt1 = 14, kRobustIt2 = 12, kRobustIt3 = 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// Four consecutive elements p[0..3] as fp32, the first `valid` of them read
// (the rest 0); one 16-byte (fp32) or 8-byte (bf16) load when `vec` and all
// four are valid.
__device__ __forceinline__ void ld4(float (&v)[4], const float* p, int valid,
                                    bool vec) {
  if (vec && valid >= 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = i < valid ? p[i] : 0.f;
}

__device__ __forceinline__ void ld4(float (&v)[4], const __nv_bfloat16* p,
                                    int valid, bool vec) {
  if (vec && valid >= 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
    v[0] = __low2float(lo);
    v[1] = __high2float(lo);
    v[2] = __low2float(hi);
    v[3] = __high2float(hi);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = i < valid ? __bfloat162float(p[i]) : 0.f;
}

// Four fp32 values rounded to bf16 (nearest-even) into 8 bytes of shared
// memory (bf16 bit patterns, kept as uint16_t).
__device__ __forceinline__ void st4_bf16(uint16_t* p, const float (&v)[4]) {
  uint2 x;
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  x.x = *reinterpret_cast<uint32_t*>(&lo);
  x.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = x;
}

__device__ __forceinline__ int clamp4(int n) { return n < 0 ? 0 : n; }

// -- gemm_tn: C (M x N, ldc) = A^T B, A stored K x M (lda), B K x N (ldb) --

template <bool BF>
struct TnStage {
  static constexpr int P = BF ? kTnTile + 8 : kTnTile;  // row pitch
  using T = typename std::conditional<BF, uint16_t, float>::type;
  T a[2][kTnStage][P];
  T b[2][kTnStage][P];
};

template <bool BF, typename AT>
__global__ void __launch_bounds__(kGemmThreads)
gemm_tn(int M, int N, int K, const AT* A, int lda, const float* B, int ldb,
        float* C, int ldc, int chunk, int vec_a, int vec_b, int xt,
        long long sa, long long sb, long long sc) {
  constexpr int kRedP = kTnTile + 1;
  constexpr int kStageBytes = (int)sizeof(TnStage<BF>);
  constexpr int kRedBytes = 4 * kTnTile * kRedP * 4;
  __shared__ __align__(16)
      unsigned char raw[kStageBytes > kRedBytes ? kStageBytes : kRedBytes];
  __shared__ float tile[kTnTile * kTnTile];
  TnStage<BF>& s = *reinterpret_cast<TnStage<BF>*>(raw);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // Member mb of a batched launch: x holds xt column tiles a member.
  const int mb = (int)blockIdx.x / xt;
  A += mb * sa;
  B += mb * sb;
  C += mb * sc;
  const int i0 = blockIdx.y * kTnTile, j0 = (blockIdx.x - mb * xt) * kTnTile;
  const int kb = blockIdx.z * chunk;
  const int ke = min(K, kb + chunk);

  // 64 x 32 of each operand per stage: four 4-wide pieces a thread.
  float ra[4][4], rb[4][4];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = t + kGemmThreads * q, row = e >> 3, c4 = (e & 7) * 4;
      const int k = k0 + row;
      const bool live = k < ke;
      ld4(ra[q], live ? A + (long long)k * lda + i0 + c4 : A,
          live ? min(4, clamp4(M - i0 - c4)) : 0, vec_a != 0);
      ld4(rb[q], live ? B + (long long)k * ldb + j0 + c4 : B,
          live ? min(4, clamp4(N - j0 - c4)) : 0, vec_b != 0);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = t + kGemmThreads * q, row = e >> 3, c4 = (e & 7) * 4;
      if constexpr (BF) {
        st4_bf16(&s.a[buf][row][c4], ra[q]);
        st4_bf16(&s.b[buf][row][c4], rb[q]);
      } else {
        *reinterpret_cast<float4*>(&s.a[buf][row][c4]) =
            make_float4(ra[q][0], ra[q][1], ra[q][2], ra[q][3]);
        *reinterpret_cast<float4*>(&s.b[buf][row][c4]) =
            make_float4(rb[q][0], rb[q][1], rb[q][2], rb[q][3]);
      }
    }
  };

  // Accumulators: bf16 -> 2 x 4 mma tiles (rows mi*16 + g (+8), columns
  // ni*8 + 2c (+1)); fp32 -> rows 4*(lane/4) + a, columns 8*(lane%4) + b.
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const int kk = 16 * warp;  // this warp's slice of every stage
  auto compute = [&](int buf) {
    if constexpr (BF) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4_t(af[mi], &s.a[buf][kk + (lane & 7) + ((lane >> 4) & 1) * 8]
                              [mi * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t b[4];
        ldsm_x4_t(b, &s.b[buf][kk + (lane & 15)][nj * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          float(&c0)[4] = *reinterpret_cast<float(*)[4]>(
              &acc[(mi * 4 + 2 * nj) * 4]);
          float(&c1)[4] = *reinterpret_cast<float(*)[4]>(
              &acc[(mi * 4 + 2 * nj + 1) * 4]);
          mma_bf16(c0, af[mi], b[0], b[1]);
          mma_bf16(c1, af[mi], b[2], b[3]);
        }
      }
    } else {
      const int ty = lane >> 2, tx = lane & 3;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(
            &s.a[buf][kk + k][4 * ty]);
        const float4 b0 = *reinterpret_cast<const float4*>(
            &s.b[buf][kk + k][8 * tx]);
        const float4 b1 = *reinterpret_cast<const float4*>(
            &s.b[buf][kk + k][8 * tx + 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 8; ++y)
            acc[x * 8 + y] = fmaf(av[x], bv[y], acc[x * 8 + y]);
      }
    }
  };

  int buf = 0;
  load(kb);
  store(0);
  __syncthreads();
  for (int k0 = kb; k0 < ke; k0 += kTnStage) {
    const bool next = k0 + kTnStage < ke;
    if (next) load(k0 + kTnStage);
    compute(buf);
    if (next) {
      store(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
  }
  __syncthreads();  // the stage buffers become the warps' partial tiles

  float* red = reinterpret_cast<float*>(raw);
  float* mine = red + warp * kTnTile * kRedP;
  if constexpr (BF) {
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* v = &acc[(mi * 4 + ni) * 4];
        const int i = mi * 16 + g, j = ni * 8 + 2 * c;
        mine[i * kRedP + j] = v[0];
        mine[i * kRedP + j + 1] = v[1];
        mine[(i + 8) * kRedP + j] = v[2];
        mine[(i + 8) * kRedP + j + 1] = v[3];
      }
  } else {
    const int ty = lane >> 2, tx = lane & 3;
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 8; ++y)
        mine[(4 * ty + x) * kRedP + 8 * tx + y] = acc[x * 8 + y];
  }
  __syncthreads();
  const int S = (int)gridDim.z;
  for (int e = t; e < kTnTile * kTnTile; e += kGemmThreads) {
    const int i = e >> 5, j = e & 31, o = i * kRedP + j;
    const int W = kTnTile * kRedP;
    const float v = ((red[o] + red[W + o]) + red[2 * W + o]) + red[3 * W + o];
    if (S == 1) {
      if (i0 + i < M && j0 + j < N) C[(long long)(i0 + i) * ldc + j0 + j] = v;
    } else {
      tile[e] = v;
    }
  }
  if (S == 1) return;
  // The cluster's S partial tiles, added in rank order: rank q finishes
  // every element e with (e / 128) % S == q.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int q = (int)cluster.block_rank();
  for (int e = q * kGemmThreads + t; e < kTnTile * kTnTile;
       e += S * kGemmThreads) {
    float v = *cluster.map_shared_rank(tile + e, 0);
    for (int p = 1; p < S; ++p) v += *cluster.map_shared_rank(tile + e, p);
    const int i = e >> 5, j = e & 31;
    if (i0 + i < M && j0 + j < N) C[(long long)(i0 + i) * ldc + j0 + j] = v;
  }
  cluster.sync();  // no CTA leaves while another reads its tile
}

// -- gemm_nt: C (M x N, ldc) = / -= A B, A M x K (lda), B K x N (ldb) -----

// Warps of a BM x BN tile: four along N when BN >= 64, else two by two.
template <int BM, int BN>
struct NtShape {
  static constexpr int WN = BN >= 64 ? 4 : 2, WM = 4 / WN;
  static constexpr int MI = BM / WM / 16, NI = BN / WN / 8;  // mma tiles
  static constexpr int TX = BN / 4, TY = kGemmThreads / TX;  // fp32 threads
  static constexpr int RM = BM / TY;                         // fp32 rows
  static constexpr int QA = BM * kNtDepth / 4 / kGemmThreads;
  static constexpr int QB = BN * kNtDepth / 4 / kGemmThreads;
  static_assert(MI >= 1 && NI % 2 == 0 && RM >= 1, "tile too small");
};

template <int BM, int BN, bool BF>
struct NtStage;
template <int BM, int BN>
struct NtStage<BM, BN, true> {
  uint16_t a[2][BM][kNtDepth + 8];  // bf16, m-major: ldmatrix
  uint16_t b[2][kNtDepth][BN + 8];  // bf16, k-major: ldmatrix.trans
};
template <int BM, int BN>
struct NtStage<BM, BN, false> {
  float a[1][kNtDepth][BM];  // k-major for broadcast reads
  float b[1][kNtDepth][BN];
};

template <int BM, int BN, bool BF, typename AT>
__global__ void __launch_bounds__(kGemmThreads)
gemm_nt(int M, int N, int K, const AT* A, int lda, const float* B, int ldb,
        float* C, int ldc, int sub, int vec_a, int vec_b, int vec_c, int xt,
        long long sa, long long sb, long long sc) {
  using Sh = NtShape<BM, BN>;
  __shared__ __align__(16) NtStage<BM, BN, BF> s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // Member mb of a batched launch: x holds xt column blocks a member.
  const int mb = (int)blockIdx.x / xt;
  A += mb * sa;
  B += mb * sb;
  C += mb * sc;
  const int i0 = blockIdx.y * BM, j0 = (blockIdx.x - mb * xt) * BN;

  float ra[Sh::QA][4], rb[Sh::QB][4];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < Sh::QA; ++q) {
      const int e = t + kGemmThreads * q, row = e >> 3, c4 = (e & 7) * 4;
      const bool live = i0 + row < M;
      ld4(ra[q], live ? A + (long long)(i0 + row) * lda + k0 + c4 : A,
          live ? min(4, clamp4(K - k0 - c4)) : 0, vec_a != 0);
    }
#pragma unroll
    for (int q = 0; q < Sh::QB; ++q) {
      const int e = t + kGemmThreads * q;
      const int row = e / (BN / 4), c4 = (e % (BN / 4)) * 4;
      const bool live = k0 + row < K;
      ld4(rb[q], live ? B + (long long)(k0 + row) * ldb + j0 + c4 : B,
          live ? min(4, clamp4(N - j0 - c4)) : 0, vec_b != 0);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < Sh::QA; ++q) {
      const int e = t + kGemmThreads * q, row = e >> 3, c4 = (e & 7) * 4;
      if constexpr (BF) {
        st4_bf16(&s.a[buf][row][c4], ra[q]);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x) s.a[0][c4 + x][row] = ra[q][x];
      }
    }
#pragma unroll
    for (int q = 0; q < Sh::QB; ++q) {
      const int e = t + kGemmThreads * q;
      const int row = e / (BN / 4), c4 = (e % (BN / 4)) * 4;
      if constexpr (BF)
        st4_bf16(&s.b[buf][row][c4], rb[q]);
      else
        *reinterpret_cast<float4*>(&s.b[0][row][c4]) =
            make_float4(rb[q][0], rb[q][1], rb[q][2], rb[q][3]);
    }
  };

  constexpr int kAcc = BF ? Sh::MI * Sh::NI * 4 : Sh::RM * 4;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  const int wm0 = (warp / Sh::WN) * (BM / Sh::WM);
  const int wn0 = (warp % Sh::WN) * (BN / Sh::WN);
  const int tx = t % Sh::TX, ty = t / Sh::TX;
  auto compute = [&](int buf) {
    if constexpr (BF) {
#pragma unroll
      for (int ks = 0; ks < kNtDepth; ks += 16) {
        uint32_t af[Sh::MI][4];
#pragma unroll
        for (int mi = 0; mi < Sh::MI; ++mi)
          ldsm_x4(af[mi], &s.a[buf][wm0 + mi * 16 + (lane & 15)]
                              [ks + (lane >> 4) * 8]);
#pragma unroll
        for (int nj = 0; nj < Sh::NI / 2; ++nj) {
          uint32_t b[4];
          ldsm_x4_t(b, &s.b[buf][ks + (lane & 15)]
                           [wn0 + nj * 16 + (lane >> 4) * 8]);
#pragma unroll
          for (int mi = 0; mi < Sh::MI; ++mi) {
            float(&c0)[4] = *reinterpret_cast<float(*)[4]>(
                &acc[(mi * Sh::NI + 2 * nj) * 4]);
            float(&c1)[4] = *reinterpret_cast<float(*)[4]>(
                &acc[(mi * Sh::NI + 2 * nj + 1) * 4]);
            mma_bf16(c0, af[mi], b[0], b[1]);
            mma_bf16(c1, af[mi], b[2], b[3]);
          }
        }
      }
    } else {
#pragma unroll 8
      for (int k = 0; k < kNtDepth; ++k) {
        float bv[4];
#pragma unroll
        for (int y = 0; y < 4; ++y) bv[y] = s.b[0][k][tx + Sh::TX * y];
#pragma unroll
        for (int x = 0; x < Sh::RM; ++x) {
          const float av = s.a[0][k][ty + Sh::TY * x];
#pragma unroll
          for (int y = 0; y < 4; ++y)
            acc[x * 4 + y] = fmaf(av, bv[y], acc[x * 4 + y]);
        }
      }
    }
  };

  // bf16: two stage buffers; fp32: one (the next stage waits in registers
  // until every warp has read the current one).
  int buf = 0;
  load(0);
  store(0);
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += kNtDepth) {
    const bool next = k0 + kNtDepth < K;
    if (next) load(k0 + kNtDepth);
    compute(buf);
    if (next) {
      if constexpr (BF) {
        store(buf ^ 1);
        buf ^= 1;
      } else {
        __syncthreads();
        store(0);
      }
      __syncthreads();
    }
  }

  auto put = [&](int i, int j, float v) {
    if (i < M && j < N) {
      float* p = C + (long long)i * ldc + j;
      *p = sub ? *p - v : v;
    }
  };
  if constexpr (BF) {
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int mi = 0; mi < Sh::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < Sh::NI; ++ni) {
        const float* v = &acc[(mi * Sh::NI + ni) * 4];
        const int j = j0 + wn0 + ni * 8 + 2 * c;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = i0 + wm0 + mi * 16 + g + 8 * h;
          if (vec_c && i < M && j + 1 < N) {
            float2* p = reinterpret_cast<float2*>(C + (long long)i * ldc + j);
            float2 o = sub ? *p : make_float2(0.f, 0.f);
            o.x = sub ? o.x - v[2 * h] : v[2 * h];
            o.y = sub ? o.y - v[2 * h + 1] : v[2 * h + 1];
            *p = o;
          } else {
            put(i, j, v[2 * h]);
            put(i, j + 1, v[2 * h + 1]);
          }
        }
      }
  } else {
#pragma unroll
    for (int x = 0; x < Sh::RM; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y)
        put(i0 + ty + Sh::TY * x, j0 + tx + Sh::TX * y, acc[x * 4 + y]);
  }
}

// -- launch helpers ------------------------------------------------------

// Whether every row of every member starts on `elems` elements' bytes:
// the pointer, the leading dimension and the member stride.
template <typename T>
static inline bool aligned_rows(const T* p, int ld, int elems,
                                long long stride = 0) {
  return ld % elems == 0 && stride % elems == 0 &&
         reinterpret_cast<uintptr_t>(p) % (sizeof(T) * elems) == 0;
}

// The members of a batched product: n products of one shape, member b's
// A, B and C at b strides (elements) past member 0's.  The member is
// folded into the grid's x (gemm_tn keeps z for its split); every element
// of every member has the sum of a single launch.  One member: n = 1.
struct Members {
  int n;
  long long a, b, c;
};
constexpr Members kOneMember{1, 0, 0, 0};

// C = A^T B (gemm_tn): `split` CTAs of one cluster share each 32 x 32
// tile's K, in chunks of `chunk` rows (ops/kernels/ns.py::tn_split); with
// `mb`, one launch for its members.
template <typename AT>
static inline cudaError_t tn(cudaStream_t st, bool bf, int M, int N, int K,
                             const AT* A, int lda, const float* B, int ldb,
                             float* C, int ldc, int split, int chunk,
                             const Members& mb = kOneMember) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (split < 1 || split > kTnMaxSplit || chunk < 1 ||
      (long long)split * chunk < K || mb.n < 1 || mb.n > kMaxBatch)
    return cudaErrorInvalidValue;
  const int xt = (N + kTnTile - 1) / kTnTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(xt * mb.n, (M + kTnTile - 1) / kTnTile, split);
  cfg.blockDim = dim3(kGemmThreads, 1, 1);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int va = aligned_rows(A, lda, 4, mb.a);
  const int vb = aligned_rows(B, ldb, 4, mb.b);
  return bf ? cudaLaunchKernelEx(&cfg, gemm_tn<true, AT>, M, N, K, A, lda, B,
                                 ldb, C, ldc, chunk, va, vb, xt, mb.a, mb.b,
                                 mb.c)
            : cudaLaunchKernelEx(&cfg, gemm_tn<false, AT>, M, N, K, A, lda, B,
                                 ldb, C, ldc, chunk, va, vb, xt, mb.a, mb.b,
                                 mb.c);
}

template <int BM, int BN, typename AT>
static inline cudaError_t nt_launch(cudaStream_t st, bool bf, int M, int N,
                                    int K, const AT* A, int lda,
                                    const float* B, int ldb, float* C,
                                    int ldc, bool sub, const Members& mb) {
  const int xt = (N + BN - 1) / BN;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(xt * mb.n, (M + BM - 1) / BM, 1);
  cfg.blockDim = dim3(kGemmThreads, 1, 1);
  cfg.stream = st;
  const int va = aligned_rows(A, lda, 4, mb.a);
  const int vb = aligned_rows(B, ldb, 4, mb.b);
  const int vc = aligned_rows(C, ldc, 2, mb.c);
  return bf ? cudaLaunchKernelEx(&cfg, gemm_nt<BM, BN, true, AT>, M, N, K, A,
                                 lda, B, ldb, C, ldc, (int)sub, va, vb, vc,
                                 xt, mb.a, mb.b, mb.c)
            : cudaLaunchKernelEx(&cfg, gemm_nt<BM, BN, false, AT>, M, N, K,
                                 A, lda, B, ldb, C, ldc, (int)sub, va, vb,
                                 vc, xt, mb.a, mb.b, mb.c);
}

// The (bm, bn) tiles gemm_nt is built for: bn is the chain's instantiation
// for the panel width (32, 64, 128; 128 above), bm the small tile of the
// r-wide products or the 64-row tile of the wide ones (ops/kernels/ns.py::
// NT_SMALL_BM, NT_WIDE_BM).
static inline bool nt_tile_ok(int bm, int bn) {
  switch (bn) {
    case 128:
    case 64: return bm == 16 || bm == 64;
    case 32: return bm == 32 || bm == 64;
    default: return false;
  }
}

// C = A B (sub == false) or C -= A B with the (bm, bn) tile; with `mb`, one
// launch for its members.  A in place of C (Q = P X) needs bn >= N: every
// CTA then reads only the rows it writes.
template <typename AT>
static inline cudaError_t nt(cudaStream_t st, bool bf, int M, int N, int K,
                             const AT* A, int lda, const float* B, int ldb,
                             float* C, int ldc, bool sub, int bm, int bn,
                             const Members& mb = kOneMember) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (mb.n < 1 || mb.n > kMaxBatch) return cudaErrorInvalidValue;
#define MPBQR_NT(BM, BN)                                                     \
  if (bm == BM && bn == BN)                                                  \
    return nt_launch<BM, BN, AT>(st, bf, M, N, K, A, lda, B, ldb, C, ldc,     \
                                 sub, mb)
  MPBQR_NT(16, 128);
  MPBQR_NT(64, 128);
  MPBQR_NT(16, 64);
  MPBQR_NT(64, 64);
  MPBQR_NT(32, 32);
  MPBQR_NT(64, 32);
#undef MPBQR_NT
  return cudaErrorInvalidValue;
}

// out = triu(T3 @ (T2 @ T1)) with leading dimension ldo: the robust
// three-pass R block (ns.py:_tri_ns_panel, robust branch; the plain
// version is ops/kernels/ns.py::tri_combine_plain).  T1..T3 are the full
// r x r products X_k^T G_k, so the triangle is cut once, on write.
// ceil(r / 16) CTAs (r <= R, on the instantiation R = 32, 64, 128 with
// zeros beyond r); CTA p owns the 16 columns 16 p .. 16 p + 15 of T1,
// A = T2 T1 and the output.  Each holds T2 and T3 whole in shared memory (cp.async,
// T3 still arriving while the first product runs) and its columns of T1
// and A transposed, so both products have the form of ns_chain.cuh's
// general prod_gen and are local:
//   A[:, own] = T2 T1[:, own],   out[:, own] = triu(T3 A[:, own]).
// No exchange, so no cluster: a plain grid, whose CTAs can be placed
// wherever K2's wide stream leaves room.  True fp32 FMA in prod_gen's
// fixed order.  What bounds it: two dependent 2 r^3 products, each bound
// by its CTA's shared-memory bandwidth, and at r = 128 the 128 KB of T2
// and T3 that each CTA reads from L2 (T3's load overlaps the first).
template <int R>
struct CombineLayout {
  static constexpr int CTAS = R / kStripe;
  static constexpr int LDF = ChainLayout<R>::LDF;
  static constexpr int FULL = R * LDF;
  static constexpr int STRIPE = kStripe * LDF;
  static constexpr int OFF_T2 = 0;
  static constexpr int OFF_T3 = FULL;
  static constexpr int OFF_T1 = 2 * FULL;        // own columns of T1^T
  static constexpr int OFF_A = OFF_T1 + STRIPE;  // own columns of A^T
  static constexpr int OFF_PART = OFF_A + STRIPE;  // prod_gen's partials
  static constexpr int BYTES = (OFF_PART + kGenPart<R>) * 4;
};

// The combine's members: member blockIdx.y's T1..T3 lie b * t floats past
// member 0's, its output b * out (the L2 route lays out its members'
// scratch itself: launch_combine).
struct CombineBatch {
  long long t, out;
};

template <int R, bool PAD>
__global__ void __launch_bounds__(kChainThreads, 1)
combine_kernel(const float* T1, const float* T2, const float* T3, int n_arg,
               float* out, int ldo, CombineBatch bt) {
  using L = CombineLayout<R>;
  const int nr = PAD ? n_arg : R;  // ns_chain.cuh, "Widths"
  {
    const long long b = blockIdx.y;
    T1 += b * bt.t;
    T2 += b * bt.t;
    T3 += b * bt.t;
    out += b * bt.out;
  }
  extern __shared__ __align__(16) float sm[];
  const int c0 = kStripe * blockIdx.x;
  float* T1t = sm + L::OFF_T1;
  float* At = sm + L::OFF_A;
  float* part = sm + L::OFF_PART;
  load_full_async<R>(sm + L::OFF_T2, T2, nr, nr);
  load_full_async<R>(sm + L::OFF_T3, T3, nr, nr);
  for (int e = threadIdx.x; e < kStripe * R; e += kChainThreads) {
    const int k = e / kStripe, q = e % kStripe;
    T1t[q * L::LDF + k] =
        (k < nr && c0 + q < nr) ? T1[(size_t)k * nr + c0 + q] : 0.f;
  }
  cp_async_wait<1>();  // T2
  __syncthreads();
  prod_gen<R>(sm + L::OFF_T2, T1t, part,
              [&](int p, int q, float v) { At[q * L::LDF + p] = v; });
  cp_async_wait<0>();  // T3
  __syncthreads();
  // The tile goes through A's buffer (read in full before the epilogue)
  // so that the stores below write whole 64-byte row segments.
  prod_gen<R>(sm + L::OFF_T3, At, part, [&](int p, int q, float v) {
    At[q * L::LDF + p] = c0 + q >= p ? v : 0.f;
  });
  __syncthreads();
  for (int e = threadIdx.x; e < kStripe * R; e += kChainThreads) {
    const int p = e / kStripe, q = e % kStripe;
    if (p < nr && c0 + q < nr) out[(size_t)p * ldo + c0 + q] = At[q * L::LDF + p];
  }
}

// The combine on the L2 route (r > 128, where T2 and T3 no longer fit a
// CTA):
//   A = T2 T1,   out = triu(T3 A)
// cut into blocks of kCmbRows = 32 rows x kCmbCols = 16 columns, one CTA
// of kCmbThreads = 64 threads a block: a grid of ceil(r / 32) x ceil(r /
// 16) CTAs (128 at r = 256), each thread-block cluster the row blocks of
// one column block (combine_layout's CTAs: ceil(r / 32), at most the
// card's largest cluster; a CTA takes several row blocks when the cluster
// is smaller).  A CTA computes its block of A, the cluster barrier makes
// the column block of A whole, and the CTA computes its block of the
// output from it; a block wholly below the diagonal is written as zeros
// without its product.  Each product runs 64-deep stages by the copy
// engine (TMA; the descriptors prefetched at the start) into a ring of
// kL2Stages slots with full / empty mbarriers and no block barrier a
// stage, as ns_chain.cuh's l2_tprod; the first operand is read row-major
// (k contiguous) in boxes of 32 k x 32 rows with the 128-byte swizzle, the
// second in the two 8-column tiles of the block; a warp takes a tile and
// a thread a 2 x 4 fp32 register tile (rows lane / 2 + 16 j, columns 4
// (lane % 2) + c of its warp's tile), a stage unrolled whole.  Each
// element sums k ascending from 0 by fmaf into one accumulator, as the
// products before did: the same bits.
//
// Why this cut (A / B on the H100, PERF.md section 6): with one cluster of
// up to 16 CTAs over contiguous or dealt columns (the first L2 design, and
// l2_tprod's with T2^T and T3^T copied k-major) every CTA reads both r x r
// operands whole, 512 KB at r = 256, and it took 0.050 / 0.034 ms device
// against 0.013 for T3 @ (T2 @ T1) on the whole card; row blocks of 64
// rows (64 CTAs, 4 x 4 tiles) took 0.013, and of 32 rows 0.010: two warps
// a CTA, so more SMs and fewer products a warp are what shortens it.
// Reading T2 and T3 row-major needs no transposed copy; its one condition,
// rows of whole 16-byte pieces for the tensor maps, is met by copying
// T1..T3 into the scratch with rows padded to l2_ld(r) (cudaMemcpy2DAsync)
// when r is not a multiple of 4 (or a T not 16-byte aligned); A = T2 T1
// always lives there.  The scratch of B members: T1, T2, T3 (used only by
// the copy) and A, each B x r x l2_ld(r) floats, member b's at b r
// l2_ld(r) floats past member 0's.  What bounds it: each CTA's two 32 x 16
// x r products at two warps' issue rate, the copy engine's first stage of
// each, and the cluster barrier between them.
constexpr int kCmbRows = 32;     // rows of a CTA's block
constexpr int kCmbRT = kCmbRows / 16;  // rows of a thread's tile
constexpr int kCmbCols = 16;     // columns of a CTA's block: two tiles
constexpr int kCmbThreads = 64;  // a warp a tile of 8 columns
constexpr int kCmbBox = 32;      // k of a box of the first operand
// A stage: the first operand's two boxes [32 rows][32 k] (swizzled), then
// the second's two tiles [64 k][8 columns]; the ring after kL2RingSlack
// floats (its mbarriers and room to start it on 1024 bytes):
// ns.py::COMBINE_RING_FLOATS.
constexpr int kCmbStageFloats = kL2UDepth * (kCmbRows + kCmbCols);
constexpr int kCmbRingFloats = kL2Stages * kCmbStageFloats;
static_assert(kCmbStageFloats % 256 == 0, "every stage 1024-byte aligned");
static_assert(kCmbCols == 2 * kL2Tile && kCmbThreads == 32 * 2,
              "a warp a tile");

// D[i][c] = sum_k P[i][k] Q[k][c] for the rows [i0, i0 + kCmbRows) and
// the columns [c0, c0 + 16) (P from mapP's boxes, Q from mapQ's tiles,
// member coordinate b; the stages through `ring`, whose `empty` barriers
// count the block's two warps); epi(i, c, value) once an element i, c <
// n, or with TILE epi(i, c, acc) once a thread: rows i + 16 j (j <
// kCmbRT), columns c .. c + 3 (c < l2_ld(n), a multiple of 4; rows and
// columns past n included), acc[4 j + column].  Every thread of the block
// calls it.
template <bool TILE = false, class Epi>
__device__ void cmb_prod(int n, const CUtensorMap* mapP,
                         const CUtensorMap* mapQ, int b, int i0, int c0,
                         L2Ring& ring, Epi epi) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ns = (n + kL2UDepth - 1) / kL2UDepth;
  // One stage, by thread 0, once both warps are done with the slot: the
  // boxes that hold some k < n (a box wholly past n is not read).
  auto fetch = [&](int s) {
    const int g = ring.seq + s, slot = g % kL2Stages;
    if (g >= kL2Stages)
      l2_mbar_wait(ring.empty(slot), (g / kL2Stages - 1) & 1);
    float* sp = ring.buf + slot * kCmbStageFloats;
    float* sq = sp + kL2UDepth * kCmbRows;
    const uint32_t bar = ring.full(slot);
    const int k0 = s * kL2UDepth;
    const bool second = k0 + kCmbBox < n;
    const bool tile1 = c0 + kL2Tile < n;
    l2_mbar_arrive_tx(bar, 4 * (kCmbBox * kCmbRows * (second ? 2 : 1) +
                                kL2UDepth * kL2Tile * (tile1 ? 2 : 1)));
    l2_tma_load(sp, mapP, bar, k0, i0, b);
    if (second)
      l2_tma_load(sp + kCmbBox * kCmbRows, mapP, bar, k0 + kCmbBox, i0, b);
    l2_tma_load(sq, mapQ, bar, c0, k0, b);
    if (tile1)
      l2_tma_load(sq + kL2UDepth * kL2Tile, mapQ, bar, c0 + kL2Tile, k0, b);
  };
  const int rl = lane >> 1, sw = rl & 7;
  float acc[4 * kCmbRT];
#pragma unroll
  for (int q = 0; q < 4 * kCmbRT; ++q) acc[q] = 0.f;
  if (tid == 0)
    for (int s = 0; s < kL2Stages - 1 && s < ns; ++s) fetch(s);
  for (int s = 0; s < ns; ++s) {
    const int slot = (ring.seq + s) % kL2Stages;
    if (tid == 0 && s + kL2Stages - 1 < ns) fetch(s + kL2Stages - 1);
    l2_mbar_wait(ring.full(slot), ((ring.seq + s) / kL2Stages) & 1);
    const float* sp = ring.buf + slot * kCmbStageFloats;
    const float* sq = sp + kL2UDepth * kCmbRows + warp * kL2UDepth * kL2Tile +
                      4 * (lane & 1);
    // One k-quad: P's 16-byte piece of k-quad kq in row r lies in box kq
    // / 32, piece (kq % 32) / 4 ^ r % 8 (CU_TENSOR_MAP_SWIZZLE_128B).
    auto quad = [&](int kq) {
      const float* pb = sp + (kq >> 5) * (kCmbBox * kCmbRows) +
                        ((((kq & 31) >> 2) ^ sw) << 2);
      float4 a[kCmbRT], q4[4];
#pragma unroll
      for (int j = 0; j < kCmbRT; ++j)
        a[j] = *reinterpret_cast<const float4*>(pb + (rl + 16 * j) * kCmbBox);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        q4[kk] = *reinterpret_cast<const float4*>(sq + (kq + kk) * kL2Tile);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float bv[4] = {q4[kk].x, q4[kk].y, q4[kk].z, q4[kk].w};
#pragma unroll
        for (int j = 0; j < kCmbRT; ++j) {
          const float av = kk == 0 ? a[j].x : kk == 1 ? a[j].y
                         : kk == 2 ? a[j].z : a[j].w;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[4 * j + c] = fmaf(av, bv[c], acc[4 * j + c]);
        }
      }
    };
    // The k of this stage: a whole stage unrolled, so that the loads of
    // the next k-quads run under this one's products (two warps an SM
    // hide little); past n the last quad's k arrive as zeros, and a box
    // wholly past n is never read.
    const int kn = min(kL2UDepth, n - s * kL2UDepth);
    if (kn == kL2UDepth) {
#pragma unroll
      for (int kq = 0; kq < kL2UDepth; kq += 4) quad(kq);
    } else {
#pragma unroll 4
      for (int kq = 0; kq < kn; kq += 4) quad(kq);
    }
    __syncwarp();
    if (lane == 0) l2_mbar_arrive(ring.empty(slot));
  }
  ring.seq += ns;
  if constexpr (TILE) {
    const int c = c0 + kL2Tile * warp + 4 * (lane & 1);
    if (c < l2_ld(n)) epi(i0 + rl, c, acc);
  } else {
#pragma unroll
    for (int q = 0; q < 4 * kCmbRT; ++q) {
      const int i = i0 + rl + 16 * (q >> 2);
      const int c = c0 + kL2Tile * warp + 4 * (lane & 1) + (q & 3);
      if (i < n && c < n) epi(i, c, acc[q]);
    }
  }
}

// Member blockIdx.y of the launch: its output at b out_stride floats past
// member 0's, its A at b n l2_ld(n) floats past At; CTA x of the grid the
// row blocks [rank nb, (rank + 1) nb) of column block x / cluster.
static __global__ void __launch_bounds__(kCmbThreads)
combine_l2_kernel(int n, int nb, float* out, int ldo, long long out_stride,
                  float* At, const __grid_constant__ CUtensorMap mapT1,
                  const __grid_constant__ CUtensorMap mapT2,
                  const __grid_constant__ CUtensorMap mapT3,
                  const __grid_constant__ CUtensorMap mapA) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = (int)blockIdx.y, ld = l2_ld(n);
  const int c0 = kCmbCols * ((int)blockIdx.x / cs);
  out += b * out_stride;
  At += (size_t)b * n * ld;
  extern __shared__ __align__(16) float sm[];
  if (threadIdx.x == 0) {  // the four descriptors, ahead of the first copy
    const CUtensorMap* maps[4] = {&mapT1, &mapT2, &mapT3, &mapA};
    for (int k = 0; k < 4; ++k)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(maps[k]))
                   : "memory");
  }
  L2Ring ring = l2_ring_init(sm, kCmbThreads / 32);
  // A[rows, cols] = T2[rows, :] T1[:, cols].
  for (int j = 0; j < nb; ++j) {
    const int i0 = kCmbRows * (rank * nb + j);
    if (i0 >= n) break;
    cmb_prod<true>(n, &mapT2, &mapT1, b, i0, c0, ring,
                   [&](int i, int c, const float(&acc)[4 * kCmbRT]) {
#pragma unroll
                     for (int q = 0; q < kCmbRT; ++q)
                       if (i + 16 * q < n)
                         *reinterpret_cast<float4*>(
                             At + (size_t)(i + 16 * q) * ld + c) =
                             make_float4(acc[4 * q], acc[4 * q + 1],
                                         acc[4 * q + 2], acc[4 * q + 3]);
                   });
  }
  l2_fence_proxy_global();  // the cluster's TMA reads these next
  l2_barrier(cluster);
  // out[rows, cols] = triu(T3[rows, :] A[:, cols]).
  for (int j = 0; j < nb; ++j) {
    const int i0 = kCmbRows * (rank * nb + j);
    if (i0 >= n) break;
    if (i0 > c0 + kCmbCols - 1) {  // wholly below the diagonal
      for (int e = threadIdx.x; e < kCmbRows * kCmbCols; e += kCmbThreads) {
        const int i = i0 + e / kCmbCols, c = c0 + e % kCmbCols;
        if (i < n && c < n) out[(size_t)i * ldo + c] = 0.f;
      }
      continue;
    }
    cmb_prod(n, &mapT3, &mapA, b, i0, c0, ring, [&](int i, int c, float v) {
      out[(size_t)i * ldo + c] = c >= i ? v : 0.f;
    });
  }
}

static inline int combine_smem_bytes(int r) {
  switch (chain_inst(r)) {
    case 32: return CombineLayout<32>::BYTES;
    case 64: return CombineLayout<64>::BYTES;
    case 128: return CombineLayout<128>::BYTES;
    default: return (kL2RingSlack + kCmbRingFloats) * 4;
  }
}

// The L2 route's matrices: T1..T3 (the padded copies) and A.
constexpr int kL2CombineMats = 4;

// Floats of the combine's global scratch for width r (one member): the L2
// route's four matrices; none on the shared-memory route.
static inline long long combine_scratch_floats(int r) {
  return chain_inst(r) ? 0 : (long long)kL2CombineMats * r * l2_ld(r);
}

// Most CTAs of the L2 combine's cluster for width r: its row blocks.
static inline int combine_max_ctas(int r) {
  return std::min(kL2MaxCluster, (r + kCmbRows - 1) / kCmbRows);
}

// The combine's layout for width r (ns.py::combine_layout): up to 128 a
// plain grid of ceil(r / 16) CTAs; above, clusters of `l2_ctas` CTAs
// (ns.py's min(ceil(r / 32), the card's largest cluster, 16)), one a
// column block of 16.
static inline KernelLayout combine_layout(int r, int l2_ctas) {
  const int inst = chain_inst(r);
  return KernelLayout{inst, inst ? 0 : 1,
                      inst ? (r + kStripe - 1) / kStripe : l2_ctas,
                      (int)combine_scratch_floats(r), combine_smem_bytes(r)};
}

// Whether `lay` is the combine's layout for width r.
static inline bool combine_layout_ok(int r, const KernelLayout& lay) {
  if (r < 1 || r > kMaxWidth) return false;
  const KernelLayout want = combine_layout(r, lay.ctas);
  return lay.inst == want.inst && lay.route == want.route &&
         lay.ctas == want.ctas && lay.scratch_floats == want.scratch_floats &&
         lay.smem_bytes == want.smem_bytes &&
         (lay.inst || (lay.ctas >= 1 && lay.ctas <= combine_max_ctas(r)));
}

template <int R>
static inline cudaError_t launch_combine_r(cudaStream_t st, dim3 grid,
                                           const float* T1, const float* T2,
                                           const float* T3, int nr,
                                           float* out, int ldo,
                                           const CombineBatch& bt) {
  using L = CombineLayout<R>;
  auto kern = nr == R ? &combine_kernel<R, false> : &combine_kernel<R, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  kern<<<grid, kChainThreads, L::BYTES, st>>>(T1, T2, T3, nr, out, ldo, bt);
  return cudaGetLastError();
}

// A tensor map of `members` n x n matrices (rows of `pitch` floats, member
// b at b * mstride floats past `base`): the first operand's boxes (32 k x
// kCmbRows rows, 128-byte swizzle) or, with `tiles`, the second's (8
// columns x 64 k).  Elements past n arrive as zeros.
static inline cudaError_t cmb_map(CUtensorMap* map, const float* base, int n,
                                  long long pitch, int members,
                                  long long mstride, bool tiles) {
  const L2EncodeFn fn = l2_encode_fn();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)n,
                              (cuuint64_t)members};
  const cuuint64_t strides[2] = {(cuuint64_t)pitch * 4,
                                 (cuuint64_t)mstride * 4};
  const cuuint32_t boxP[3] = {kCmbBox, kCmbRows, 1};
  const cuuint32_t boxQ[3] = {kL2Tile, kL2UDepth, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base),
         dims, strides, tiles ? boxQ : boxP, estr,
         CU_TENSOR_MAP_INTERLEAVE_NONE,
         tiles ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The combine for width r (1 .. kMaxWidth, checked by the caller) with the
// layout `lay` (combine_layout_ok) on `st`; T1..T3 r x r, row-major;
// `scratch` holds lay.scratch_floats a member (16-byte aligned).  With
// `batch` > 1 one launch (grid (CTAs, batch)) runs that many members at
// the strides of `bt` (the scratch: batch members, as the L2 route lays
// them out).  Returns the first error met.
static inline cudaError_t launch_combine(int r, const KernelLayout& lay,
                                         cudaStream_t st, const float* T1,
                                         const float* T2, const float* T3,
                                         float* out, int ldo, float* scratch,
                                         int batch = 1,
                                         const CombineBatch& bt =
                                             CombineBatch{}) {
  if (batch < 1 || batch > kMaxBatch) return cudaErrorInvalidValue;
  switch (lay.inst) {
#define MPBQR_COMBINE(RR)                                                    \
  case RR:                                                                   \
    return launch_combine_r<RR>(st, dim3(lay.ctas, batch, 1), T1, T2, T3,    \
                                r, out, ldo, bt)
    MPBQR_COMBINE(32);
    MPBQR_COMBINE(64);
    MPBQR_COMBINE(128);
#undef MPBQR_COMBINE
    default: break;
  }
  if (reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return cudaErrorInvalidValue;
  const int ld = l2_ld(r);
  const long long mat = (long long)r * ld;
  const long long tstride = batch > 1 ? bt.t : (long long)r * r;
  const float* T[3] = {T1, T2, T3};
  long long pitch = r, mstride = tstride;
  bool direct = r % 4 == 0 && tstride % 4 == 0;
  for (const float* t : T)
    direct = direct && reinterpret_cast<uintptr_t>(t) % 16 == 0;
  cudaError_t err = cudaSuccess;
  if (!direct) {  // T1..T3 into the scratch, rows padded to ld
    for (int k = 0; k < 3; ++k) {
      float* dst = scratch + k * batch * mat;
      if (batch == 1 || tstride == (long long)r * r) {
        err = cudaMemcpy2DAsync(dst, ld * 4, T[k], r * 4, r * 4,
                                (size_t)r * batch, cudaMemcpyDeviceToDevice,
                                st);
      } else {
        for (int m = 0; m < batch && err == cudaSuccess; ++m)
          err = cudaMemcpy2DAsync(dst + m * mat, ld * 4, T[k] + m * tstride,
                                  r * 4, r * 4, r, cudaMemcpyDeviceToDevice,
                                  st);
      }
      if (err != cudaSuccess) return err;
      T[k] = dst;
    }
    pitch = ld;
    mstride = mat;
  }
  float* At = scratch + 3 * batch * mat;
  CUtensorMap maps[4];
  for (int k = 0; k < 3 && err == cudaSuccess; ++k)
    err = cmb_map(&maps[k], T[k], r, pitch, batch, mstride, k == 0);
  if (err == cudaSuccess) err = cmb_map(&maps[3], At, r, ld, batch, mat, true);
  if (err != cudaSuccess) return err;
  const int cs = lay.ctas;
  const int nb = ((r + kCmbRows - 1) / kCmbRows + cs - 1) / cs;
  err = cudaFuncSetAttribute(combine_l2_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             lay.smem_bytes);
  if (err == cudaSuccess && cs > 8)
    err = cudaFuncSetAttribute(combine_l2_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs * ((r + kCmbCols - 1) / kCmbCols), batch, 1);
  cfg.blockDim = dim3(kCmbThreads, 1, 1);
  cfg.dynamicSmemBytes = lay.smem_bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, combine_l2_kernel, r, nb, out, ldo, bt.out,
                           At, maps[0], maps[1], maps[2], maps[3]);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The layout a panel product sequence runs with (ops/kernels/ns.py::
// group_layout): the tall products' split and chunk, the small and wide
// row tiles of gemm_nt and its column tile, and the route of the products
// (kPanelRoute: this header's gemm_tn / gemm_nt; kStackRoute, a stack's
// only: stack_gemm.cu's, where bm_panel / bm_wide are rows per CTA).
constexpr int kPanelRoute = 0, kStackRoute = 1;
constexpr int kStackTile = 128;  // stack_gemm.cu's output tile
struct ProductLayout {
  int split, chunk, bm_panel, bm_wide, bn;
  int route = kPanelRoute;
};

// gemm_nt's column tile for panel width r (ns.py::_nt_bn).
static inline int nt_bn(int r) {
  const int inst = chain_inst(r);
  return inst ? inst : 128;
}

// Whether `lay` is one the kernels run for an m x r panel: the split's
// chunks cover m with none empty and a chunk a whole number of stages,
// bn == nt_bn(r), and on the panel route tiles that gemm_nt is built for;
// on the stack route (ns.py::stack_route) r of 128 or 256, at least one
// stage of rows and whole 128-row tiles a CTA.  Any other route is
// refused.
static inline bool product_layout_ok(int m, int r, const ProductLayout& lay) {
  if (r < 1 || r > kMaxWidth) return false;
  if (lay.split < 1 || lay.split > kTnMaxSplit || lay.chunk < kTnStage ||
      lay.chunk % kTnStage != 0)
    return false;
  if ((long long)lay.split * lay.chunk < m ||
      (long long)(lay.split - 1) * lay.chunk >= m)
    return false;
  if (lay.bn != nt_bn(r)) return false;
  if (lay.route == kStackRoute)
    return (r == kStackTile || r == 2 * kStackTile) && m >= kTnStage &&
           lay.bm_panel >= kStackTile && lay.bm_panel % kStackTile == 0 &&
           lay.bm_wide >= kStackTile && lay.bm_wide % kStackTile == 0;
  return lay.route == kPanelRoute && nt_tile_ok(lay.bm_panel, lay.bn) &&
         nt_tile_ok(lay.bm_wide, lay.bn);
}

}  // namespace mpbqr
