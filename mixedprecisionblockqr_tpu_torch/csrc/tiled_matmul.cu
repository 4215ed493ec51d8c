// K8: C = A @ B for any (m, k) x (k, n), in the four type combinations of
// the reference: f32 x f32 -> f32 (true fp32), bf16 x bf16 -> f32,
// bf16 x bf16 -> bf16 (fp32 accumulator, one rounding at the end) and
// s8 x s8 -> s32 (exact).
//
// Replaces mixedprecisionblockqr_tpu/ops/pallas/gemm.py::tiled_matmul
// (pl.pallas_call of _gemm_kernel).
//
// What bounds it on this card: operations, at every size worth a kernel
// (2 m n k against (m k + k n + m n) elements).  So the design is about
// reaching the unit that does them fastest and keeping it fed:
//   * bf16, operands that TMA can describe (16-byte-aligned base, row
//     stride a multiple of 16 bytes, k > 0): gemm_tma_wgmma.  Persistent
//     CTAs, one per SM, walk the 128 x 128 output tiles.  One producer
//     thread keeps a ring of kStages stages of 128B-swizzled tiles
//     (A 128 x 64, B 64 x 128 as two 64-wide boxes) in flight with
//     cp.async.bulk.tensor.2d, completion on an mbarrier per stage; two
//     consumer warpgroups each own 64 rows of the tile and run
//     wgmma.mma_async m64n128k16 with the fp32 accumulator in registers,
//     releasing a stage through a second mbarrier.  A is K-major and B is
//     read N-contiguous ("MN-major") through its descriptor with the
//     transpose bit, so neither operand is copied or staged transposed.  TMA
//     zero-fills rows and columns beyond the matrix, so ragged m, n, k need
//     no padded copies; the stores are predicated.  bf16 x bf16 products are
//     exact in fp32: only the order of the fp32 sum differs from FMA.
//   * bf16 that TMA cannot describe, and s8 always: gemm_mma_sync.  The
//     predicated loader (32-bit loads where base and strides allow, element
//     loads otherwise) fills registers for the next 64-byte k-slice while
//     the tensor cores work on the current one (two shared-memory buffers,
//     one barrier a slice).  8-bit tensor-core products take both operands
//     K-major, and B is N-contiguous, so B's tile is transposed on its way
//     into shared memory, 4 x 4 bytes at a time in registers (prmt); bf16
//     takes the same path with 2 x 2.  mma.sync m16n8k16 (bf16) and
//     m16n8k32 (s8) with fragments read as 32-bit words.  s32 sums are exact.
//   * f32: true fp32 on the FMA units, never TF32; a 128 x 128 tile a CTA,
//     an 8 x 8 register block a thread, k summed in ascending order.  With
//     operands that TMA can describe: gemm_f32_tma, the same ring as bf16
//     (one producer thread, 4 stages of 32-deep slices, full / empty
//     mbarriers) feeding 8 warps of FMA, which make no global loads and
//     hold no operand in flight in registers.  Otherwise gemm_f32: the predicated loader fills
//     registers with the next 16-deep slice before the FMAs of the current
//     one and stores it to the other buffer after them.
// k == 0 gives zeros on every route.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace mpbqr {

constexpr int kTM = 128, kTN = 128;

// -- bf16: wgmma fed by TMA -------------------------------------------------

constexpr int kBK = 64;        // bf16 elements of k per stage: one 128B row
constexpr int kStages = 5;
constexpr int kABytes = kTM * kBK * 2;       // 16 KB
constexpr int kBBoxBytes = kBK * 64 * 2;     // 8 KB: 64 k-rows x 64 n
constexpr int kStageBytes = kABytes + 2 * kBBoxBytes;
constexpr int kWgmmaThreads = 384;           // 2 consumer warpgroups + producer
constexpr int kWgmmaSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
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
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor of a 128B-swizzled operand: leading and
// stride byte offsets in 16-byte units, layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d += A (64 x 16, K-major) @ B (16 x 128, N-contiguous: transpose bit set).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
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
      "%64, %65, p, 1, 1, 0, 1;\n"
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

__device__ __forceinline__ void store_pair(float* p, float a, float b,
                                           bool both, bool vec) {
  if (both && vec) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (both) p[1] = b;
  }
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b,
                                           bool both, bool vec) {
  if (both && vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
    if (both) p[1] = __float2bfloat16_rn(b);
  }
}

// mapA: A as (k inner, m outer), box 64 x 128; mapB: B as (n inner, k
// outer), box 64 x 64; both 128B-swizzled.  C has leading dimension ldc.
template <typename TOut>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
gemm_tma_wgmma(const __grid_constant__ CUtensorMap mapA,
               const __grid_constant__ CUtensorMap mapB, TOut* C, int M, int N,
               int K, int ldc) {
  extern __shared__ char raw[];
  // 128B-swizzled tiles need 1024-byte alignment.
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kStages * kStageBytes;
  auto sA = [&](int s) { return base + s * kStageBytes; };
  auto sB = [&](int s) { return base + s * kStageBytes + kABytes; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int tiles_m = (M + kTM - 1) / kTM, tiles_n = (N + kTN - 1) / kTN;
  const int ntiles = tiles_m * tiles_n;
  const int nk = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // Producer: one thread keeps the ring full.
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int tm = tile % tiles_m, tn = tile / tiles_m;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), kStageBytes);
          tma_load_2d(sA(stage), &mapA, full(stage), kb * kBK, tm * kTM);
          tma_load_2d(sB(stage), &mapB, full(stage), tn * kTN, kb * kBK);
          tma_load_2d(sB(stage) + kBBoxBytes, &mapB, full(stage),
                      tn * kTN + 64, kb * kBK);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile.
    const int wtid = threadIdx.x & 127;
    const int warp = wtid >> 5, g = (wtid & 31) >> 2, t = wtid & 3;
    const bool vec = (ldc & 1) == 0;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int tm = tile % tiles_m, tn = tile / tiles_m;
      float d[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0.f;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(full(stage), phase);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) {
          // A: 8-row groups 1024 bytes apart, 32 bytes of k a step.
          const uint64_t da =
              smem_desc(sA(stage) + wg * 64 * 128 + ks * 32, 16, 1024);
          // B: 16 k-rows (2048 bytes) a step; 8-row k groups 1024 bytes
          // apart, the second 64 columns one box further.
          const uint64_t db =
              smem_desc(sB(stage) + ks * 2048, kBBoxBytes, 1024);
          wgmma_m64n128k16(d, da, db);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        if (wtid == 0) mbar_arrive(empty(stage));
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      const int row = tm * kTM + wg * 64 + warp * 16 + g;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = tn * kTN + 8 * j + 2 * t;
        if (col >= N) continue;
        const bool both = col + 1 < N;
        if (row < M)
          store_pair(C + (long long)row * ldc + col, d[4 * j], d[4 * j + 1],
                     both, vec);
        if (row + 8 < M)
          store_pair(C + (long long)(row + 8) * ldc + col, d[4 * j + 2],
                     d[4 * j + 3], both, vec);
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the process has already
// loaded; nullptr if it cannot be found.
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (h) fn = reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A row-major (rows x cols, leading dimension ld) matrix as a 2-D tensor
// map with a box of box_cols x box_rows: bf16 with the 128B swizzle that
// wgmma reads, or fp32 unswizzled.
static bool encode_map(CUtensorMap* map, bool bf16, const void* ptr, int rows,
                       int cols, int ld, int box_cols, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * (bf16 ? 2 : 4)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map,
            bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TOut>
static int launch_tma(cudaStream_t st, int M, int N, int K, const void* A,
                      int lda, const void* B, int ldb, void* C, int ldc) {
  // The route rule is stated once, in gemm.py::tma_route.  Operands that
  // break it (a base or a row stride off 16 bytes, k == 0) are refused by
  // cuTensorMapEncodeTiled itself.
  CUtensorMap mapA, mapB;
  if (!encode_map(&mapA, true, A, M, K, lda, kBK, kTM) ||
      !encode_map(&mapB, true, B, K, N, ldb, 64, kBK))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gemm_tma_wgmma<TOut>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kWgmmaSmem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = ((M + kTM - 1) / kTM) * ((N + kTN - 1) / kTN);
  gemm_tma_wgmma<TOut><<<ntiles < sms ? ntiles : sms, kWgmmaThreads,
                         kWgmmaSmem, st>>>(mapA, mapB, static_cast<TOut*>(C),
                                           M, N, K, ldc);
  return (int)cudaGetLastError();
}

// -- f32: true fp32 FMA fed by TMA -------------------------------------------

constexpr int kFK = 32;       // floats of k per stage: 128-byte rows of A
constexpr int kFStages = 4;
constexpr int kFABytes = kTM * kFK * 4;   // 16 KB, [m][k]
constexpr int kFBBytes = kFK * kTN * 4;   // 16 KB, [k][n]
constexpr int kFStageBytes = kFABytes + kFBBytes;
constexpr int kFConsumers = 256;          // 8 warps of FMA
constexpr int kF32Threads = kFConsumers + 32;  // and the producer's warp
constexpr int kF32Smem = kFStages * kFStageBytes + 2 * kFStages * 8 + 128;

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// One CTA per 128 x 128 tile of C.  Thread (ty, tx) of the consumers' 16 x
// 16 layout owns rows {4 ty .. 4 ty + 3} and {64 + 4 ty ..}, columns
// likewise; products are summed k ascending, as in gemm_f32.
// mapA: A as (k inner, m outer), box 32 x 128; mapB: B as (n inner, k
// outer), box 128 x 32; both unswizzled.
__global__ void __launch_bounds__(kF32Threads, 1)
gemm_f32_tma(const __grid_constant__ CUtensorMap mapA,
             const __grid_constant__ CUtensorMap mapB, float* C, int M, int N,
             int K, int ldc) {
  extern __shared__ char raw[];
  const uint32_t pad =
      (128u - ((uint32_t)__cvta_generic_to_shared(raw) & 127u)) & 127u;
  char* tiles = raw + pad;  // TMA wants 128-byte-aligned destinations
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(tiles);
  const uint32_t bars = base + kFStages * kFStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kFStages + s); };
  const int i0 = blockIdx.y * kTM, j0 = blockIdx.x * kTN;
  const int nk = (K + kFK - 1) / kFK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kFStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kFConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kFConsumers) {
    if (threadIdx.x == kFConsumers) {  // producer
      int stage = 0;
      uint32_t phase = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), kFStageBytes);
        const uint32_t dst = base + stage * kFStageBytes;
        tma_load_2d(dst, &mapA, full(stage), kb * kFK, i0);
        tma_load_2d(dst + kFABytes, &mapB, full(stage), j0, kb * kFK);
        if (++stage == kFStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int kb = 0; kb < nk; ++kb) {
    mbar_wait(full(stage), phase);
    const float* As =
        reinterpret_cast<const float*>(tiles + stage * kFStageBytes);
    const float* Bs = As + kTM * kFK;
#pragma unroll 2
    for (int k4 = 0; k4 < kFK / 4; ++k4) {
      float4 fa[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int row = a < 4 ? 4 * ty + a : 64 + 4 * ty + a - 4;
        fa[a] = *reinterpret_cast<const float4*>(As + row * kFK + 4 * k4);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = Bs + (4 * k4 + kk) * kTN;
        const float4 b0 = *reinterpret_cast<const float4*>(brow + 4 * tx);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + 64 + 4 * tx);
        const float fb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const float av = comp(fa[a], kk);
#pragma unroll
          for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av, fb[b], acc[a][b]);
        }
      }
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(stage));
    if (++stage == kFStages) {
      stage = 0;
      phase ^= 1;
    }
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = i0 + (a < 4 ? 4 * ty + a : 64 + 4 * ty + a - 4);
    if (i >= M) continue;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = j0 + (b < 4 ? 4 * tx + b : 64 + 4 * tx + b - 4);
      if (j >= N) continue;
      C[(long long)i * ldc + j] = acc[a][b];
    }
  }
}

static int launch_f32_tma(cudaStream_t st, int M, int N, int K, const void* A,
                          int lda, const void* B, int ldb, void* C, int ldc) {
  CUtensorMap mapA, mapB;  // operands off the route rule: see launch_tma
  if (!encode_map(&mapA, false, A, M, K, lda, kFK, kTM) ||
      !encode_map(&mapB, false, B, K, N, ldb, kTN, kFK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_f32_tma, cudaFuncAttributeMaxDynamicSharedMemorySize, kF32Smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  gemm_f32_tma<<<grid, kF32Threads, kF32Smem, st>>>(
      mapA, mapB, static_cast<float*>(C), M, N, K, ldc);
  return (int)cudaGetLastError();
}

// -- bf16 and s8: mma.sync fed by the predicated loader ---------------------

constexpr int kMmThreads = 256;
constexpr int kKW = 16;      // 32-bit words of k per slice (64 bytes)
constexpr int kPW = kKW + 4;  // shared-memory row pitch in words

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
__device__ __forceinline__ uint32_t bits_of(int8_t x) { return (uint8_t)x; }

// Elements [c, c + 4 / sizeof(T)) of a row as one word, zero beyond cmax
// or when the row is out of range.
template <typename T, bool ALIGNED>
__device__ __forceinline__ uint32_t load_word(const T* row, int c, int cmax,
                                              bool row_ok) {
  constexpr int EPW = 4 / sizeof(T);
  if (!row_ok || c >= cmax) return 0u;
  if (ALIGNED && c + EPW <= cmax)
    return *reinterpret_cast<const uint32_t*>(row + c);
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < EPW; ++e)
    if (c + e < cmax) w |= bits_of(row[c + e]) << (8 * sizeof(T) * e);
  return w;
}

__device__ __forceinline__ void mma_tile(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tile(int (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void narrow(float acc, float* out) { *out = acc; }
__device__ __forceinline__ void narrow(float acc, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(acc);
}
__device__ __forceinline__ void narrow(int acc, int* out) { *out = acc; }

// TIn: __nv_bfloat16 (TAcc float) or int8_t (TAcc int).  8 warps as 2 x 4;
// a warp owns 64 x 32 of the 128 x 128 tile.  ALIGNED: both bases and both
// row strides are multiples of 4 bytes.  Two CTAs an SM (the register cap of
// the launch bounds): one's loads hide under the other's products.
template <typename TIn, typename TAcc, typename TOut, bool ALIGNED>
__global__ void __launch_bounds__(kMmThreads, 2)
gemm_mma_sync(int M, int N, int K, const TIn* A, int lda, const TIn* B,
              int ldb, TOut* C, int ldc) {
  constexpr int EPW = 4 / sizeof(TIn);   // elements in a word
  constexpr int BK = kKW * EPW;          // elements of k per slice
  constexpr int NW = kTN / EPW;          // words across the tile's columns
  constexpr int UNITS = (kKW * NW) / kMmThreads;  // EPW x EPW blocks of B
  __shared__ uint32_t As[2][kTM][kPW];
  __shared__ uint32_t Bs[2][kTN][kPW];  // transposed: [n][k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int i0 = blockIdx.y * kTM, j0 = blockIdx.x * kTN;
  const int nk = (K + BK - 1) / BK;

  TAcc acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = (TAcc)0;

  uint32_t ra[8], rb[UNITS][EPW];
  auto fetch = [&](int kb) {
    const int k0 = kb * BK;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int w = tid + q * kMmThreads;
      const int i = i0 + w / kKW;
      ra[q] = load_word<TIn, ALIGNED>(A + (long long)i * lda,
                                      k0 + (w % kKW) * EPW, K, i < M);
    }
#pragma unroll
    for (int q = 0; q < UNITS; ++q) {
      const int u = tid + q * kMmThreads;
      const int kg = (u >> 2) & (kKW - 1), nw = (u & 3) + 4 * (u >> 6);
#pragma unroll
      for (int e = 0; e < EPW; ++e) {
        const int k = k0 + kg * EPW + e;
        rb[q][e] = load_word<TIn, ALIGNED>(B + (long long)k * ldb,
                                           j0 + nw * EPW, N, k < K);
      }
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int w = tid + q * kMmThreads;
      As[buf][w / kKW][w % kKW] = ra[q];
    }
#pragma unroll
    for (int q = 0; q < UNITS; ++q) {
      const int u = tid + q * kMmThreads;
      const int kg = (u >> 2) & (kKW - 1), nw = (u & 3) + 4 * (u >> 6);
      if (EPW == 2) {
        Bs[buf][nw * 2][kg] = __byte_perm(rb[q][0], rb[q][1], 0x5410);
        Bs[buf][nw * 2 + 1][kg] = __byte_perm(rb[q][0], rb[q][1], 0x7632);
      } else {
        const uint32_t t0 = __byte_perm(rb[q][0], rb[q][1], 0x5140);
        const uint32_t t1 = __byte_perm(rb[q][0], rb[q][1], 0x7362);
        const uint32_t t2 = __byte_perm(rb[q][2 % EPW], rb[q][3 % EPW], 0x5140);
        const uint32_t t3 = __byte_perm(rb[q][2 % EPW], rb[q][3 % EPW], 0x7362);
        Bs[buf][nw * 4][kg] = __byte_perm(t0, t2, 0x5410);
        Bs[buf][nw * 4 + 1][kg] = __byte_perm(t0, t2, 0x7632);
        Bs[buf][nw * 4 + 2][kg] = __byte_perm(t1, t3, 0x5410);
        Bs[buf][nw * 4 + 3][kg] = __byte_perm(t1, t3, 0x7632);
      }
    }
  };

  if (nk > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();
  for (int kb = 0; kb < nk; ++kb) {
    const int buf = kb & 1;
    if (kb + 1 < nk) fetch(kb + 1);
#pragma unroll
    for (int ks = 0; ks < kKW / 8; ++ks) {
      const int kw = ks * 8 + t;
      uint32_t bf[4][2];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int n = wn * 32 + b * 8 + g;
        bf[b][0] = Bs[buf][n][kw];
        bf[b][1] = Bs[buf][n][kw + 4];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = wm * 64 + a * 16 + g;
        const uint32_t af[4] = {As[buf][r][kw], As[buf][r + 8][kw],
                                As[buf][r][kw + 4], As[buf][r + 8][kw + 4]};
#pragma unroll
        for (int b = 0; b < 4; ++b) mma_tile(acc[a][b], af, bf[b][0], bf[b][1]);
      }
    }
    if (kb + 1 < nk) stash(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + wm * 64 + a * 16 + g + (c >> 1) * 8;
        const int j = j0 + wn * 32 + b * 8 + 2 * t + (c & 1);
        if (i < M && j < N) narrow(acc[a][b][c], C + (long long)i * ldc + j);
      }
}

template <typename TIn, typename TAcc, typename TOut>
static int launch_mma(cudaStream_t st, int M, int N, int K, const void* A,
                      int lda, const void* B, int ldb, void* C, int ldc) {
  const dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  const TIn* a = static_cast<const TIn*>(A);
  const TIn* b = static_cast<const TIn*>(B);
  const bool aligned = !(((uintptr_t)A | (uintptr_t)B) & 3) &&
                       !((lda * sizeof(TIn)) & 3) && !((ldb * sizeof(TIn)) & 3);
  if (aligned)
    gemm_mma_sync<TIn, TAcc, TOut, true><<<grid, kMmThreads, 0, st>>>(
        M, N, K, a, lda, b, ldb, static_cast<TOut*>(C), ldc);
  else
    gemm_mma_sync<TIn, TAcc, TOut, false><<<grid, kMmThreads, 0, st>>>(
        M, N, K, a, lda, b, ldb, static_cast<TOut*>(C), ldc);
  return (int)cudaGetLastError();
}

// -- f32: true fp32 FMA, double-buffered -----------------------------------

constexpr int kTK = 16;

struct alignas(16) Float4 {
  float v[4];
};

// Thread (ty, tx) of the 16 x 16 layout owns rows {4 ty .. 4 ty + 3} and
// {64 + 4 ty ..}, columns likewise.
__global__ void __launch_bounds__(kMmThreads, 2)
gemm_f32(int M, int N, int K, const float* A, int lda, const float* B,
         int ldb, float* C, int ldc) {
  // As is stored transposed (k-major): the 4-word row pad spreads those
  // stores over the banks and keeps each row 16-byte aligned.
  __shared__ __align__(16) float As[2][kTK][kTM + 4];
  __shared__ __align__(16) float Bs[2][kTK][kTN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int i0 = blockIdx.y * kTM, j0 = blockIdx.x * kTN;
  const int nk = (K + kTK - 1) / kTK;
  constexpr int PER = (kTM * kTK) / kMmThreads;
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  float ra[PER], rb[PER];
  auto fetch = [&](int kb) {
    const int k0 = kb * kTK;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = threadIdx.x + q * kMmThreads;
      const int i = e / kTK, k = e % kTK;  // A: contiguous along k
      ra[q] = (i0 + i < M && k0 + k < K)
                  ? A[(long long)(i0 + i) * lda + k0 + k] : 0.f;
      const int kk = e / kTN, j = e % kTN;  // B: contiguous along j
      rb[q] = (j0 + j < N && k0 + kk < K)
                  ? B[(long long)(k0 + kk) * ldb + j0 + j] : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = threadIdx.x + q * kMmThreads;
      As[buf][e % kTK][e / kTK] = ra[q];
      Bs[buf][e / kTN][e % kTN] = rb[q];
    }
  };

  if (nk > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();
  for (int kb = 0; kb < nk; ++kb) {
    const int buf = kb & 1;
    if (kb + 1 < nk) fetch(kb + 1);
#pragma unroll
    for (int k = 0; k < kTK; ++k) {
      float fa[8], fb[8];
      const Float4 a0 = *reinterpret_cast<const Float4*>(&As[buf][k][4 * ty]);
      const Float4 a1 =
          *reinterpret_cast<const Float4*>(&As[buf][k][64 + 4 * ty]);
      const Float4 b0 = *reinterpret_cast<const Float4*>(&Bs[buf][k][4 * tx]);
      const Float4 b1 =
          *reinterpret_cast<const Float4*>(&Bs[buf][k][64 + 4 * tx]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        fa[c] = a0.v[c];
        fa[4 + c] = a1.v[c];
        fb[c] = b0.v[c];
        fb[4 + c] = b1.v[c];
      }
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(fa[a], fb[b], acc[a][b]);
    }
    if (kb + 1 < nk) stash(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = i0 + (a < 4 ? 4 * ty + a : 64 + 4 * ty + a - 4);
    if (i >= M) continue;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = j0 + (b < 4 ? 4 * tx + b : 64 + 4 * tx + b - 4);
      if (j >= N) continue;
      C[(long long)i * ldc + j] = acc[a][b];
    }
  }
}

}  // namespace mpbqr

extern "C" {

// C (m x n) = A (m x k) @ B (k x n), row-major with leading dimensions
// lda / ldb / ldc in elements, device pointers.  combo: 0 = f32 -> f32,
// 1 = bf16 -> f32, 2 = bf16 -> bf16, 3 = s8 -> s32.  tma != 0 asks for the
// kernels fed by TMA (bf16 and f32 combos only; bases 16-byte aligned, lda
// and ldb multiples of 16 bytes, k > 0); otherwise the predicated loaders
// run.  k == 0
// gives zeros.  Returns the launch's CUDA error, or cudaErrorInvalidValue
// for an unknown combo, an empty output or a TMA request that the operands
// do not allow.
int mpbqr_tiled_matmul(const void* A, const void* B, void* C, int m, int n,
                       int k, int lda, int ldb, int ldc, int combo, int tma,
                       void* stream) {
  using namespace mpbqr;
  if (m < 1 || n < 1 || k < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (tma) {
    if (combo == 0)
      return launch_f32_tma(st, m, n, k, A, lda, B, ldb, C, ldc);
    if (combo == 1)
      return launch_tma<float>(st, m, n, k, A, lda, B, ldb, C, ldc);
    if (combo == 2)
      return launch_tma<__nv_bfloat16>(st, m, n, k, A, lda, B, ldb, C, ldc);
    return (int)cudaErrorInvalidValue;
  }
  switch (combo) {
    case 0: {
      const dim3 grid((n + kTN - 1) / kTN, (m + kTM - 1) / kTM);
      gemm_f32<<<grid, kMmThreads, 0, st>>>(
          m, n, k, static_cast<const float*>(A), lda,
          static_cast<const float*>(B), ldb, static_cast<float*>(C), ldc);
      return (int)cudaGetLastError();
    }
    case 1:
      return launch_mma<__nv_bfloat16, float, float>(st, m, n, k, A, lda, B,
                                                     ldb, C, ldc);
    case 2:
      return launch_mma<__nv_bfloat16, float, __nv_bfloat16>(
          st, m, n, k, A, lda, B, ldb, C, ldc);
    case 3:
      return launch_mma<int8_t, int, int>(st, m, n, k, A, lda, B, ldb, C, ldc);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
