// Per-level GBDT histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel mmlspark_tpu/models/gbdt/hist_pallas.py:_hist_kernel
// (driven by _pallas_level_histogram). It computes exactly what that kernel
// returns: a (width, F, B, 3) float32 histogram whose cell (node, f, bin)
// holds the sums of grad*live, hess*live and live over the rows of `node`
// whose feature f falls in `bin`.
//
// Why not a block-by-block copy of the TPU design. The Pallas kernel runs
// its grid in order on one core, so a node's accumulator stays in VMEM over
// consecutive row blocks, and it turns binning into a one-hot matmul on the
// MXU. Neither holds here: CTAs run in parallel and in no order, and a
// one-hot product would spend B times the operations for nothing.
//
// Design. The wrapper (models/gbdt/hist_cuda.py) sorts rows by node
// (stable) and cuts every node's rows into tiles of `tile_rows`; CTA
// (tile, feature slice) owns one tile of one node. Each CTA keeps a private
// float[F_slice][B][3] histogram in dynamic shared memory, walks its rows
// through the sorted order with consecutive threads on consecutive features
// of one row (one coalesced read of the row's bin bytes; two lanes of a
// warp can hit the same shared cell only where the warp spans two rows and
// both lanes hold the same feature), skips rows with live == 0, and
// adds with shared-memory atomics. At the end it flushes its non-zero cells
// into the output with global atomics; the wrapper zeroes the output first.
// The grid is a static upper bound on the tile count (n / tile_rows + width)
// so the host never reads a device value; surplus CTAs find no node and
// exit at once.
//
// What bounds it. Per level the function must read the N x F bin bytes,
// the three (N,) float32 vectors and the (N,) node ids (int64 on the
// training path): at N = 2M, F = 28 that is 96 MB, about 29 us at the H100
// SXM's 3.35 TB/s. The arithmetic (3 adds per row and
// feature) is two orders below the card's f32 rate, so the bound is bytes.
// Rows are read in node order, so below the root a warp's 32 rows sit at
// scattered addresses; each row's F bytes stay contiguous, and the design
// reads them in one transaction per row. Shared atomics and the flush of
// F_slice*B*3 cells per CTA are the overheads over the bound; tile_rows is
// chosen so the flush is amortized over thousands of rows.
//
// Numbers. Float atomics add in an order that changes from run to run, so
// grad/hess sums are reproducible only to float tolerance. Counts, and any
// integer-valued stats whose partial sums stay below 2^24, are exact and
// bitwise equal to the plain version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
level_hist_kernel(const uint8_t* __restrict__ binned,     // (n, f) row-major
                  const float* __restrict__ grad,         // (n,)
                  const float* __restrict__ hess,         // (n,)
                  const float* __restrict__ live,         // (n,)
                  const int64_t* __restrict__ order,      // (n,) rows by node
                  const int64_t* __restrict__ offsets,    // (width + 1,)
                  const int64_t* __restrict__ tile_end,   // (width,) tiles, prefix sum
                  float* __restrict__ out,                // (width, f, b, 3)
                  int f, int b, int width, int tile_rows, int f_slice) {
  extern __shared__ float sh[];  // (f_slice, b, 3)

  // node owning this tile: the first node whose tile prefix sum exceeds it
  const int64_t t = blockIdx.x;
  int lo = 0, hi = width;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tile_end[mid] > t) hi = mid; else lo = mid + 1;
  }
  const int node = lo;
  if (node >= width) return;  // surplus tile of the static grid bound

  const int64_t first_tile = node > 0 ? tile_end[node - 1] : 0;
  const int64_t start = offsets[node] + (t - first_tile) * tile_rows;
  const int64_t stop = offsets[node + 1];
  const int rows = (int)(stop - start < tile_rows ? stop - start : tile_rows);
  const int f0 = blockIdx.y * f_slice;
  const int fs = f - f0 < f_slice ? f - f0 : f_slice;
  const int cells = fs * b * 3;

  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = 0.f;
  __syncthreads();

  const int work = rows * fs;
  for (int i = threadIdx.x; i < work; i += blockDim.x) {
    const int64_t r = order[start + i / fs];
    const float lv = live[r];
    if (lv == 0.f) continue;
    const int fl = i % fs;
    const int bin = binned[r * f + f0 + fl];
    if (bin >= b) continue;  // out-of-range ids are the caller's bug; never write past the tile
    float* cell = sh + (fl * b + bin) * 3;
    atomicAdd(cell, grad[r] * lv);
    atomicAdd(cell + 1, hess[r] * lv);
    atomicAdd(cell + 2, lv);
  }
  __syncthreads();

  // the slice's cells are contiguous in the (width, f, b, 3) output
  float* dst = out + ((int64_t)node * f + f0) * b * 3;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const float v = sh[i];
    if (v != 0.f) atomicAdd(dst + i, v);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of device `device`.
// Returns cudaGetLastError() after the launch: 0 on success.
int mmls_level_hist(const void* binned, const void* grad, const void* hess,
                    const void* live, const void* order, const void* offsets,
                    const void* tile_end, void* out, int f, int b, int width,
                    int tile_rows, int num_tiles, int f_slice, int num_slices,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = f_slice * b * 3 * (int)sizeof(float);
  err = cudaFuncSetAttribute(level_hist_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)num_tiles, (unsigned)num_slices);
  level_hist_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)binned, (const float*)grad, (const float*)hess,
      (const float*)live, (const int64_t*)order, (const int64_t*)offsets,
      (const int64_t*)tile_end, (float*)out, f, b, width, tile_rows, f_slice);
  return (int)cudaGetLastError();
}

const char* mmls_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
