// Quantized per-level GBDT histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel mmlspark_tpu/models/gbdt/hist_pallas.py:_hist_kernel
// as driven by pallas_level_histogram_quant (hist_pallas.py:204), the entry
// the JAX trainer takes under MMLSPARK_TPU_HIST_QUANT=q16|q8. It computes what
// the JAX package's native merge defines (native/data_plane.cpp, the
// mmls_level_hist_q16/_q8 kernels): for int16 or int8 grad/hess under shared
// power-of-two scales, a (width, F, B, 3) float32 histogram whose cell
// (node, f, bin) holds float32(sum(grad_q) * double(gscale_inv)),
// float32(sum(hess_q) * double(hscale_inv)) and the row count, over the rows
// of `node` whose feature f falls in `bin`. Sums are exact integers, rounded
// to float32 once.
//
// Design. The tile plan and the CTA walk are the float32 kernel's
// (level_hist.cu): the wrapper (models/gbdt/hist_cuda.py) sorts rows by node
// (stable), with rows whose live <= 0 sorted past the last node so that they
// fall in no tile, and CTA (tile, feature slice) owns one tile of one node.
// Each CTA keeps a private int32[F_slice][B][3] histogram in dynamic shared
// memory (85,680 B at F = 28, B = 255, as the float32 kernel) and adds with
// shared-memory integer atomics. A cell grows by at most |q| <= 2^15 per row
// of the tile, so it stays below 2^31 for tile_rows <= 2^16 (the wrapper
// checks this; it plays the part of the native kernel's periodic flush). At
// the end the CTA adds its non-zero cells into a zeroed int64 buffer with
// 64-bit atomics; sign-extended two's-complement adds give the exact signed
// sum. Integer adds commute, so the result is the same bits whatever order
// the CTAs run in: the fit on this kernel is reproducible run to run. A
// second, elementwise kernel dequantizes the int64
// sums into the float32 output (int64 -> double is exact below 2^53, the
// product by a power of two is exact, and the cast to float is the one
// rounding). In the JAX package too the dequantization lies outside the
// Pallas body (hist_pallas.py:218-219). The tile lookup, the flush and the
// dequantization are level_hist_common.cuh's, shared with level_hist.cu.
//
// What bounds it. Per level the function must read the N x F bin bytes, the
// two (N,) int16/int8 vectors, the (N,) float32 live mask and the (N,) int64
// node ids, and write the (width, F, B, 3) float32 histogram: at N = 2M,
// F = 28 about 84-88 MB, some 26 us at the H100 SXM's 3.35 TB/s. The adds
// (3 per live row and feature) are far below the card's integer rate, so the
// bound is bytes. As in the float32 kernel, shared atomics and the flush of
// F_slice * B * 3 cells per CTA are the overheads over the bound.

#include <cstdint>
#include <cuda_runtime.h>

#include "level_hist_common.cuh"

namespace {

constexpr int kThreads = 512;

template <typename Q>
__global__ void __launch_bounds__(kThreads)
level_hist_quant_kernel(const uint8_t* __restrict__ binned,     // (n, f)
                        const Q* __restrict__ grad,             // (n,)
                        const Q* __restrict__ hess,             // (n,)
                        const int64_t* __restrict__ order,      // (n,) rows by node
                        const int64_t* __restrict__ offsets,    // (width + 1,)
                        const int64_t* __restrict__ tile_end,   // (width,) prefix sum
                        unsigned long long* __restrict__ acc,   // (width, f, b, 3)
                        int f, int b, int width, int tile_rows, int f_slice) {
  extern __shared__ int shq[];  // (f_slice, b, 3)

  const level_hist::Tile tile =
      level_hist::find_tile(offsets, tile_end, width, tile_rows);
  if (tile.node >= width) return;  // surplus tile of the static grid bound
  const int f0 = blockIdx.y * f_slice;
  const int fs = f - f0 < f_slice ? f - f0 : f_slice;
  const int cells = fs * b * 3;

  for (int i = threadIdx.x; i < cells; i += blockDim.x) shq[i] = 0;
  __syncthreads();

  // every row of a tile is live: the tile plan left the others out
  const int work = tile.rows * fs;
  for (int i = threadIdx.x; i < work; i += blockDim.x) {
    const int64_t r = order[tile.start + i / fs];
    const int fl = i % fs;
    const int bin = binned[r * f + f0 + fl];
    if (bin >= b) continue;  // out-of-range ids are the caller's bug; never write past the tile
    int* cell = shq + (fl * b + bin) * 3;
    atomicAdd(cell, (int)grad[r]);
    atomicAdd(cell + 1, (int)hess[r]);
    atomicAdd(cell + 2, 1);
  }
  __syncthreads();

  // the slice's cells are contiguous in the (width, f, b, 3) buffer
  level_hist::flush_cells(shq, acc + ((int64_t)tile.node * f + f0) * b * 3,
                          cells);
}

// The scales of grad and hess (float32 inverse scales on the device); the
// count channel's is 1.
struct InverseScales {
  const float* g;
  const float* h;
  __device__ double operator()(int c) const {
    return c == 0 ? (double)*g : (c == 1 ? (double)*h : 1.0);
  }
};

template <typename Q>
int launch(const void* binned, const void* grad, const void* hess,
           const void* order, const void* offsets, const void* tile_end,
           void* acc, void* out, const void* gscale_inv,
           const void* hscale_inv, int f, int b, int width, int tile_rows,
           int num_tiles, int f_slice, int num_slices, cudaStream_t stream) {
  const int smem = f_slice * b * 3 * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      level_hist_quant_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)num_tiles, (unsigned)num_slices);
  level_hist_quant_kernel<Q><<<grid, kThreads, smem, stream>>>(
      (const uint8_t*)binned, (const Q*)grad, (const Q*)hess,
      (const int64_t*)order, (const int64_t*)offsets,
      (const int64_t*)tile_end, (unsigned long long*)acc, f, b, width,
      tile_rows, f_slice);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)level_hist::dequantize(
      (const long long*)acc, (float*)out,
      InverseScales{(const float*)gscale_inv, (const float*)hscale_inv},
      (int64_t)width * f * b * 3, stream);
}

}  // namespace

extern "C" {

// Launches the histogram kernel and the dequantization on `stream` (a
// cudaStream_t) of device `device`; `qbits` is 16 (int16 grad/hess) or 8
// (int8). `acc` must hold zeros. Returns the first CUDA error: 0 on success.
int mmls_level_hist_quant(const void* binned, const void* grad,
                          const void* hess, const void* order,
                          const void* offsets, const void* tile_end,
                          void* acc, void* out, const void* gscale_inv,
                          const void* hscale_inv, int qbits, int f, int b,
                          int width, int tile_rows, int num_tiles,
                          int f_slice, int num_slices, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (qbits == 16)
    return launch<int16_t>(binned, grad, hess, order, offsets, tile_end, acc,
                           out, gscale_inv, hscale_inv, f, b, width,
                           tile_rows, num_tiles, f_slice, num_slices,
                           (cudaStream_t)stream);
  if (qbits == 8)
    return launch<int8_t>(binned, grad, hess, order, offsets, tile_end, acc,
                          out, gscale_inv, hscale_inv, f, b, width,
                          tile_rows, num_tiles, f_slice, num_slices,
                          (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

const char* mmls_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
