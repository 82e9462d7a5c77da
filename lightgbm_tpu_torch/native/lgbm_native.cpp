// The native text-parsing tier of lightgbm_tpu_torch.
//
// A copy of lightgbm_tpu/native/src/lgbm_native.cpp's parser (the port
// imports nothing of the JAX package, not its C++ either): delimited text
// -> row-major float64 matrix, OpenMP over rows, each token through
// strtod on a copy of at most 63 characters (the reference's locale-free
// Atof, utils/common.h: na/nan/unparseable parse as 0).  Its value_to_bin
// is not copied: neither package calls it (binning is numpy).
//
// Built at first use by lightgbm_tpu_torch/native/lib.py:
//   g++ -O3 -fopenmp -shared -fPIC -std=c++17 lgbm_native.cpp -o <lib>

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// Locale-free float parse; na/nan/garbage parse as 0 like the reference's
// Atof (utils/common.h:177-178 treats na/nan as 0).
inline double parse_token(const char* begin, const char* end) {
  while (begin < end && (*begin == ' ' || *begin == '\t')) ++begin;
  if (begin >= end) return 0.0;
  char buf[64];
  size_t len = static_cast<size_t>(end - begin);
  if (len >= sizeof(buf)) len = sizeof(buf) - 1;
  std::memcpy(buf, begin, len);
  buf[len] = '\0';
  char* parse_end = nullptr;
  double value = std::strtod(buf, &parse_end);
  if (parse_end == buf) return 0.0;  // na / nan / unparseable
  if (std::isnan(value)) return 0.0;
  return value;
}

}  // namespace

extern "C" {

// Parse `nrows` lines of `delim`-separated numbers from `blob` into the
// preallocated row-major out[nrows*ncols].  Returns 0 on success, nonzero
// when any line has the wrong column count (the caller falls back to the
// exact tier for the reference-style error).
int parse_delimited(const char* blob, long long blob_len, char delim,
                    long long nrows, long long ncols, double* out) {
  // pass 1: line starts
  std::vector<const char*> starts;
  starts.reserve(static_cast<size_t>(nrows) + 1);
  const char* p = blob;
  const char* end = blob + blob_len;
  starts.push_back(p);
  for (const char* q = p; q < end; ++q) {
    if (*q == '\n' && q + 1 < end) starts.push_back(q + 1);
  }
  if (static_cast<long long>(starts.size()) < nrows) return 1;

  int bad = 0;
  // pass 2: parse rows in parallel
#pragma omp parallel for schedule(static)
  for (long long i = 0; i < nrows; ++i) {
    const char* line = starts[static_cast<size_t>(i)];
    const char* line_end =
        (i + 1 < static_cast<long long>(starts.size()))
            ? starts[static_cast<size_t>(i + 1)] - 1
            : end;
    while (line_end > line && (line_end[-1] == '\n' || line_end[-1] == '\r'))
      --line_end;
    long long col = 0;
    const char* tok = line;
    for (const char* q = line; q <= line_end; ++q) {
      if (q == line_end || *q == delim) {
        if (col < ncols) out[i * ncols + col] = parse_token(tok, q);
        ++col;
        tok = q + 1;
      }
    }
    if (col != ncols) {
#pragma omp atomic write
      bad = 1;
    }
  }
  return bad;
}

// Application::Application (application.cpp:30-34): the num_threads config
// caps the OpenMP pool for every native parallel region.
void set_num_threads(int n) {
#if defined(_OPENMP)
  if (n > 0) omp_set_num_threads(n);
#else
  (void)n;
#endif
}

}  // extern "C"
