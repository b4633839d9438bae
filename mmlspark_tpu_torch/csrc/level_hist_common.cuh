// What the two level-histogram kernels (level_hist.cu, float32 stats in
// fixed point; level_hist_quant.cu, int16/int8 stats) share: the CTA's tile
// of the wrapper's tile plan, the flush of a CTA's shared integer cells into
// the int64 sums, and the elementwise dequantization of those sums.
//
// Tile plan (models/gbdt/hist_cuda.py:tile_plan): rows sorted by node
// (stable), node w owning order[offsets[w]:offsets[w+1]] cut into tiles of
// `tile_rows`, tile_end the prefix sum of each node's tile count. CTA
// (tile, feature slice) owns one tile of one node.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace level_hist {

constexpr int kDequantThreads = 256;

struct Tile {
  int node;        // >= width: a surplus tile of the static grid bound
  int64_t start;   // first position in `order`
  int rows;
};

// The tile of CTA blockIdx.x: its node is the first whose tile prefix sum
// exceeds the tile index.
__device__ __forceinline__ Tile find_tile(const int64_t* __restrict__ offsets,
                                          const int64_t* __restrict__ tile_end,
                                          int width, int tile_rows) {
  const int64_t t = blockIdx.x;
  int lo = 0, hi = width;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tile_end[mid] > t) hi = mid; else lo = mid + 1;
  }
  Tile tile{lo, 0, 0};
  if (lo >= width) return tile;
  const int64_t first_tile = lo > 0 ? tile_end[lo - 1] : 0;
  tile.start = offsets[lo] + (t - first_tile) * tile_rows;
  const int64_t left = offsets[lo + 1] - tile.start;
  tile.rows = (int)(left < tile_rows ? left : tile_rows);
  return tile;
}

// Adds a CTA's non-zero shared cells (int32 or int64) into the int64 sums
// with 64-bit atomics: sign-extended two's-complement adds give the exact
// signed sum, in any order of the CTAs.
template <typename T>
__device__ __forceinline__ void flush_cells(const T* sh,
                                            unsigned long long* __restrict__ dst,
                                            int cells) {
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const long long v = (long long)sh[i];
    if (v != 0) atomicAdd(dst + i, (unsigned long long)v);
  }
}

// out[i] = float(double(acc[i]) * scale(i % 3)): int64 -> double rounds to
// nearest even (exact below 2^53), the product by a power of two is exact,
// and the cast to float rounds to nearest even. `Scale` maps a channel to
// its double scale on the device.
template <class Scale>
__global__ void __launch_bounds__(kDequantThreads)
dequantize_kernel(const long long* __restrict__ acc, float* __restrict__ out,
                  Scale scale, int64_t n) {
  const double s0 = scale(0), s1 = scale(1), s2 = scale(2);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % 3);
    const double s = c == 0 ? s0 : (c == 1 ? s1 : s2);
    out[i] = __double2float_rn(__dmul_rn(__ll2double_rn(acc[i]), s));
  }
}

template <class Scale>
cudaError_t dequantize(const long long* acc, float* out, Scale scale,
                       int64_t n, cudaStream_t stream) {
  const int64_t want = (n + kDequantThreads - 1) / kDequantThreads;
  const int blocks = (int)(want < 65535 ? want : 65535);
  dequantize_kernel<<<blocks, kDequantThreads, 0, stream>>>(acc, out, scale,
                                                           n);
  return cudaGetLastError();
}

}  // namespace level_hist
