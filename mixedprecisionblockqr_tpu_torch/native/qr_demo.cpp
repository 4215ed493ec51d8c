// Standalone C++ Householder QR demo with self-check.
//
// Role parity with the reference's C++ demo (`C++/main.cpp`: explicit
// Householder H matrices checked against Eigen's HouseholderQR).  This
// version needs no third-party library: it factors a small matrix with
// explicit reflectors and self-checks the residual ||A - QR|| and
// orthogonality ||Q^T Q - I|| against the fp64 2^-52 * m criterion —
// the same acceptance rule the framework's metrics module applies.
//
// Build & run:  make -C mixedprecisionblockqr_tpu_torch/native qr_demo
//               && mixedprecisionblockqr_tpu_torch/_build/native/qr_demo

#include <cmath>
#include <cstdio>
#include <vector>

namespace {

using Mat = std::vector<double>;  // row-major

Mat matmul(const Mat& a, const Mat& b, int m, int k, int n) {
  Mat c(static_cast<size_t>(m) * n, 0.0);
  for (int i = 0; i < m; ++i)
    for (int l = 0; l < k; ++l) {
      double ail = a[i * k + l];
      for (int j = 0; j < n; ++j) c[i * n + j] += ail * b[l * n + j];
    }
  return c;
}

}  // namespace

int main() {
  const int m = 6, n = 4;
  Mat A = {
      1, 2, 3, 4,  //
      5, 4, 2, 1,  //
      0, 3, 7, 2,  //
      9, 1, 0, 4,  //
      2, 8, 5, 3,  //
      4, 0, 1, 6,
  };

  Mat R = A;
  Mat Q(m * m, 0.0);
  for (int i = 0; i < m; ++i) Q[i * m + i] = 1.0;

  for (int k = 0; k < n; ++k) {
    // Reflector for column k: w = (x + sign(x_k)||x|| e_k) / ||.||
    double sigma2 = 0.0;
    for (int i = k; i < m; ++i) sigma2 += R[i * n + k] * R[i * n + k];
    double sigma = std::sqrt(sigma2);
    if (sigma == 0.0) continue;
    double alpha = R[k * n + k];
    double sign = alpha >= 0 ? 1.0 : -1.0;
    std::vector<double> w(m, 0.0);
    for (int i = k; i < m; ++i) w[i] = R[i * n + k];
    w[k] += sign * sigma;
    double wn = 0.0;
    for (int i = k; i < m; ++i) wn += w[i] * w[i];
    wn = std::sqrt(wn);
    for (int i = k; i < m; ++i) w[i] /= wn;

    // R <- (I - 2 w w^T) R ; Q <- Q (I - 2 w w^T)
    for (int j = 0; j < n; ++j) {
      double dot = 0.0;
      for (int i = k; i < m; ++i) dot += w[i] * R[i * n + j];
      for (int i = k; i < m; ++i) R[i * n + j] -= 2.0 * w[i] * dot;
    }
    for (int i = 0; i < m; ++i) {
      double dot = 0.0;
      for (int j = k; j < m; ++j) dot += Q[i * m + j] * w[j];
      for (int j = k; j < m; ++j) Q[i * m + j] -= 2.0 * dot * w[j];
    }
  }

  // Self-check: backward error and orthogonality, 2^-bits * m criterion.
  Mat QR = matmul(Q, R, m, m, n);
  double num = 0.0, den = 0.0;
  for (int i = 0; i < m * n; ++i) {
    num += (A[i] - QR[i]) * (A[i] - QR[i]);
    den += A[i] * A[i];
  }
  double backward = std::sqrt(num / den);

  double max_orth = 0.0;
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < m; ++j) {
      double dot = 0.0;
      for (int l = 0; l < m; ++l) dot += Q[l * m + i] * Q[l * m + j];
      double want = i == j ? 1.0 : 0.0;
      double e = std::fabs(dot - want);
      if (e > max_orth) max_orth = e;
    }

  const double limit = std::ldexp(1.0, -52) * m;  // 2^-52 * m (fp64)
  bool ok = backward <= limit && max_orth <= limit;
  std::printf("||A - QR||/||A|| = %e  (limit %e)\n", backward, limit);
  std::printf("max|Q^T Q - I|   = %e  (limit %e)\n", max_orth, limit);
  std::printf("%s\n", ok ? "PASS" : "FAIL");
  return ok ? 0 : 1;
}
