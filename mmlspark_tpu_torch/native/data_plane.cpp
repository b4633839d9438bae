// Host-side quantile binning for the port: its own copy of the binning part
// of the JAX package's native data plane (native/data_plane.cpp:
// parallel_chunks, bin_lower_bound and mmls_bin_matrix), built with the host
// C++ compiler and loaded through ctypes by
// mmlspark_tpu_torch/native/bindings.py. Plain C ABI, no Python headers.
//
// A value v of feature j lands in bin 1 + lower_bound(edges_j, v), the first
// index whose upper edge is >= v, over the feature's edges padded with +inf
// to one (F, n_bins) matrix; NaN lands in bin 0, the missing bin. This is
// BinMapper._transform_python's np.searchsorted(side="left") + 1, bit for
// bit: the compares are exact float64 compares in both.
//
// What differs from the JAX package's copy, none of it a bin id:
//   - batches below kInlineRows rows run on the caller's thread; the
//     reference starts min(cores, n) threads on every call, so a served
//     one-row request paid for a thread start;
//   - NaN becomes bin 0 and the missing bin's +1 is applied inside the loop
//     (the reference does both in numpy around the call: isnan, where, +1,
//     a masked store and astype, several passes over each block);
//   - the values are read as float32 or float64 (float -> double is exact)
//     and the bin ids written as uint8, uint16 or int32, so the caller needs
//     neither a float64 staging copy nor an astype pass;
//   - a thread bins a tile of kTileRows rows feature by feature, where the
//     reference bins row by row: the same search per value, in another
//     order;
//   - the workers are the CPUs this process may run on (sched_getaffinity),
//     not every CPU of the host.

#include <sched.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Rows below which a call bins on the caller's thread: a thread start costs
// tens of microseconds, about what 4,096 rows of 28 features take to bin.
constexpr int64_t kInlineRows = 4096;
// rows binned feature by feature at once (64 rows x 28 float32 features
// and their ids stay in L1 beside one feature's edges)
constexpr int64_t kTileRows = 64;

int worker_threads() {
  cpu_set_t set;
  if (sched_getaffinity(0, sizeof(set), &set) == 0) {
    const int n = CPU_COUNT(&set);
    if (n > 0) return n;
  }
  const unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 4;
}

// parallel-for over [0, n) in contiguous chunks; inline below kInlineRows
template <typename F>
void parallel_chunks(int64_t n, F&& fn) {
  if (n < kInlineRows) {
    if (n > 0) fn(int64_t{0}, n);
    return;
  }
  const int workers = static_cast<int>(
      std::min<int64_t>(worker_threads(), n / kInlineRows));
  std::vector<std::thread> threads;
  const int64_t chunk = (n + workers - 1) / workers;
  for (int w = 0; w < workers; ++w) {
    const int64_t lo = w * chunk;
    const int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([lo, hi, &fn] { fn(lo, hi); });
  }
  for (auto& t : threads) t.join();
}

// Branchless lower_bound (first index with u[i] >= v), the reference's:
// the halving form whose select the compiler turns into a conditional move.
inline int32_t bin_lower_bound(const double* u, int32_t n, double v) {
  if (n <= 0) return 0;
  const double* base = u;
  int32_t len = n;
  while (len > 1) {
    const int32_t half = len >> 1;
    base = (base[half] < v) ? base + half : base;
    len -= half;
  }
  return static_cast<int32_t>(base - u) + (*base < v ? 1 : 0);
}

template <typename In, typename Out>
void bin_matrix(const In* vals, int64_t n, int64_t f, const double* uppers,
                int32_t n_bins, Out* out) {
  parallel_chunks(n, [&](int64_t lo, int64_t hi) {
    // a tile of rows feature by feature: the feature's edges stay in L1
    // and the tile's searches are independent of one another
    for (int64_t r0 = lo; r0 < hi; r0 += kTileRows) {
      const int64_t r1 = std::min(hi, r0 + kTileRows);
      for (int64_t j = 0; j < f; ++j) {
        const double* u = uppers + j * n_bins;
        for (int64_t i = r0; i < r1; ++i) {
          const double v = static_cast<double>(vals[i * f + j]);
          const int32_t b = std::min(bin_lower_bound(u, n_bins, v),
                                     n_bins - 1);
          out[i * f + j] = static_cast<Out>(std::isnan(v) ? 0 : b + 1);
        }
      }
    }
  });
}

template <typename In>
int bin_matrix_to(const In* vals, int64_t n, int64_t f, const double* uppers,
                  int32_t n_bins, void* out, int out_bytes) {
  switch (out_bytes) {
    case 1:
      bin_matrix(vals, n, f, uppers, n_bins, static_cast<uint8_t*>(out));
      return 0;
    case 2:
      bin_matrix(vals, n, f, uppers, n_bins, static_cast<uint16_t*>(out));
      return 0;
    case 4:
      bin_matrix(vals, n, f, uppers, n_bins, static_cast<int32_t*>(out));
      return 0;
  }
  return 2;
}

}  // namespace

extern "C" {

// Bin the row-major (n, f) matrix `vals` (float32 for val_bytes 4, float64
// for 8) by the row-major (f, n_bins) inf-padded upper edges into the
// row-major (n, f) `out` (uint8, uint16 or int32 for out_bytes 1, 2 or 4):
// NaN -> 0, else 1 + the first edge index >= the value. The caller makes
// sure the largest bin id, n_bins, fits the output type. Returns 0, or 1
// for an unknown val_bytes and 2 for an unknown out_bytes.
int mmls_bin_matrix(const void* vals, int val_bytes, int64_t n, int64_t f,
                    const double* uppers, int32_t n_bins, void* out,
                    int out_bytes) {
  if (val_bytes == 4)
    return bin_matrix_to(static_cast<const float*>(vals), n, f, uppers,
                         n_bins, out, out_bytes);
  if (val_bytes == 8)
    return bin_matrix_to(static_cast<const double*>(vals), n, f, uppers,
                         n_bins, out, out_bytes);
  return 1;
}

}  // extern "C"
