// The stack route's panel products (stack_gemm.cu), as bgs_group.cu calls
// them: a plain C++ interface, so that the group entry's translation unit
// needs neither the CUDA driver's tensor maps nor the Hopper kernels.
#pragma once

#include <cuda_runtime.h>

namespace mpbqr {

// One operand buffer of a stacked product: `members` row-major fp32
// matrices of rows x cols (leading dimension cols), member b at b * stride
// floats past member 0's.  A product reads a column range of it.
struct StackBuf {
  const float* p;
  int rows, cols;
  long long stride;
};

// C = A^T B for each of `members` members: A's columns [a_col, a_col + M)
// and B's [b_col, b_col + N), both over all K = A.rows = B.rows rows; C
// (M x N, leading dimension ldc, member stride sc).  `split` CTAs of one
// cluster share each output tile's K in chunks of `chunk` rows (a whole
// number of 64-row stages; none empty); bf rounds both operands to bf16.
cudaError_t stack_tn(cudaStream_t st, bool bf, int M, int N, int K,
                     const StackBuf& A, int a_col, const StackBuf& B,
                     int b_col, float* C, int ldc, long long sc, int split,
                     int chunk, int members);

// C = A B (sub false) or C -= A B for each member: A's columns [a_col,
// a_col + K) over all M = A.rows rows, B the K x N block of buffer Bb at
// row b_row, column b_col, C (M x N, ldc, sc).  K a multiple of 64 up to
// 256; a CTA takes rows_per_cta rows (whole 128-row tiles) of one
// 128-column block and reads every row it writes before it writes it, so
// C may be A's own columns (Q = P X in place) when N <= 128.
cudaError_t stack_nt(cudaStream_t st, bool bf, int M, int N, int K,
                     const StackBuf& A, int a_col, const StackBuf& Bb,
                     int b_row, int b_col, float* C, int ldc, long long sc,
                     bool sub, int rows_per_cta, int members);

// The narrow projection of a 128-wide panel in one launch for each member:
// G1 = P^T C into G (128 x 128, leading dimension ldg, member stride sg),
// then C -= P G1 in place, P and C the columns [p_col, p_col + 128) and
// [c_col, c_col + 128) of buffer Q (M = Q.rows rows).  One cluster of
// `split` CTAs a member, each on `chunk` rows (a whole number of 128-row
// tiles; none empty), first as stack_tn, then as stack_nt on its rows.
cudaError_t stack_proj(cudaStream_t st, bool bf, int M, const StackBuf& Q,
                       int p_col, int c_col, float* G, int ldg, long long sg,
                       int split, int chunk, int members);

}  // namespace mpbqr
