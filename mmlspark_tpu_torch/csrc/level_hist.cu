// Per-level GBDT histogram for Hopper (sm_90a), float32 stats summed in
// fixed point: the same bits in any order, on any device.
//
// Replaces the TPU kernel mmlspark_tpu/models/gbdt/hist_pallas.py:_hist_kernel
// (driven by _pallas_level_histogram). It computes what that kernel returns,
// a (width, F, B, 3) float32 histogram whose cell (node, f, bin) holds the
// sums of grad*live, hess*live and live over the rows of `node` whose
// feature f falls in `bin`, with one rounding fixed by the data rather than
// by the order of the adds:
//
//   - per channel c one power of two 2^e_c, e_c the largest integer with
//     n * amax_c * 2^e_c <= 2^62 (amax_c the largest |value| over the n
//     rows; e_c = 0 where amax_c = 0), found on the device by integer
//     exponent arithmetic (no exp2);
//   - each term round_half_even(double(x) * 2^e_c) as an int64 (the product
//     is exact: a power of two times a float);
//   - the int64 sums, exact and order-free (|sum| <= 2^62 + n/2 < 2^63);
//   - float(double(sum) * 2^-e_c), the chain level_hist_quant.cu uses.
//
// At n = 2M rows a term of the largest magnitude is about 2^41, a grid
// finer than float32's by some 2^17, so float sums land within any float32
// order's error bound, and integer-valued stats whose sums are exact in
// float32 come back bit for bit. The plain version
// (hist_cuda.level_histogram_reference) computes the same function with one
// int64 index_add_; the TPU kernel accumulates in grid order, so its fits
// are reproducible too. The float atomics this kernel used before made the
// card's float32 fit change from run to run.
//
// Why not a block-by-block copy of the TPU design. The Pallas kernel runs
// its grid in order on one core, so a node's accumulator stays in VMEM over
// consecutive row blocks, and it turns binning into a one-hot matmul on the
// MXU. Neither holds here: CTAs run in parallel and in no order, and a
// one-hot product would spend B times the operations for nothing.
//
// Design. Four launches on the stream:
//   1. amax: a grid-stride pass over the rows, per-warp maxima of
//      |grad*live|, |hess*live|, |live| merged by integer atomicMax on the
//      float bits (non-negative floats order as their bits); then one
//      thread turns each into e_c, left on the device for the next two;
//   2. the histogram: the wrapper (models/gbdt/hist_cuda.py) sorts rows by
//      node (stable), rows with live == 0 past the last node, and cuts every
//      node's rows into tiles of `tile_rows`; CTA (tile, feature slice) owns
//      one tile of one node (level_hist_common.cuh). Each CTA keeps a
//      private int64[F_slice][B][3] histogram in dynamic shared memory
//      (171,360 B at F = 28, B = 255: one CTA per SM), walks its rows with
//      consecutive threads on consecutive features of one row (one
//      coalesced read of the row's bin bytes), and adds its terms with
//      64-bit shared atomics. The scaled live channel alone is about 2^41
//      per row at n = 2M, so int32 cells would overflow. At the end it adds
//      its non-zero cells into a zeroed int64 buffer with 64-bit global
//      atomics. The grid is a static upper bound on the tile count (n /
//      tile_rows + width), so the host never reads a device value; surplus
//      CTAs find no node and exit at once;
//   3. the elementwise dequantization (level_hist_common.cuh).
// No launch waits on the host: the fit's host syncs stay flat in the tree
// count.
//
// What bounds it. Per level the function must read the N x F bin bytes,
// the three (N,) float32 vectors and the (N,) node ids (int64 on the
// training path), and write the float32 histogram: at N = 2M, F = 28 about
// 96 MB, some 29 us at the H100 SXM's 3.35 TB/s. The arithmetic (3 scaled
// adds per live row and feature) is far below the card's rate, so the bound
// is bytes. Rows are read in node order, so below the root a warp's rows
// sit at scattered addresses; each row's F bytes stay contiguous. Shared
// atomics and the flush of F_slice*B*3 cells per CTA are the overheads over
// the bound; tile_rows is chosen so the flush is amortized over thousands
// of rows.

#include <cstdint>
#include <cuda_runtime.h>

#include "level_hist_common.cuh"

namespace {

constexpr int kThreads = 1024;       // one CTA per SM: its int64 cells fill shared memory
constexpr int kAmaxThreads = 256;
constexpr int kAmaxBlocks = 264;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

// amax_bits[c] = the float bits of max |x_c| over the rows (amax_bits zeroed)
__global__ void __launch_bounds__(kAmaxThreads)
amax_kernel(const float* __restrict__ grad, const float* __restrict__ hess,
            const float* __restrict__ live,
            unsigned long long* __restrict__ amax_bits, int64_t n) {
  float g = 0.f, h = 0.f, l = 0.f;
  for (int64_t r = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; r < n;
       r += (int64_t)gridDim.x * blockDim.x) {
    const float lv = live[r];
    g = fmaxf(g, fabsf(__fmul_rn(grad[r], lv)));
    h = fmaxf(h, fabsf(__fmul_rn(hess[r], lv)));
    l = fmaxf(l, fabsf(lv));
  }
  g = warp_max(g);
  h = warp_max(h);
  l = warp_max(l);
  if (threadIdx.x % 32 == 0) {
    atomicMax(amax_bits, (unsigned long long)__float_as_uint(g));
    atomicMax(amax_bits + 1, (unsigned long long)__float_as_uint(h));
    atomicMax(amax_bits + 2, (unsigned long long)__float_as_uint(l));
  }
}

// The largest e with n * a * 2^e <= 2^62, exactly: a = m * 2^(ea - 24) with
// m = frexp's mantissa * 2^24, an integer; with L the bit length of n * m,
// e = 86 - ea - L, plus 1 where n * m is a power of two. 0 where a = 0.
__device__ int fixed_point_exponent(float a, long long n) {
  if (!(a > 0.f)) return 0;
  int ea;
  const float ma = frexpf(a, &ea);
  const unsigned long long nm =
      (unsigned long long)n * (unsigned long long)ldexpf(ma, 24);
  const int len = 64 - __clzll((long long)nm);
  return 86 - ea - len + ((nm & (nm - 1)) == 0 ? 1 : 0);
}

__global__ void exponents_kernel(const unsigned long long* __restrict__ amax_bits,
                                 long long* __restrict__ exps, int64_t n) {
  if (threadIdx.x < 3)
    exps[threadIdx.x] = fixed_point_exponent(
        __uint_as_float((unsigned)amax_bits[threadIdx.x]), n);
}

// 2^k as a double, built from its bits (|k| <= 1022 here: e_c lies in
// [-106, 234] for any finite float data).
__device__ __forceinline__ double pow2(long long k) {
  return __longlong_as_double((k + 1023) << 52);
}

__global__ void __launch_bounds__(kThreads)
level_hist_kernel(const uint8_t* __restrict__ binned,     // (n, f) row-major
                  const float* __restrict__ grad,         // (n,)
                  const float* __restrict__ hess,         // (n,)
                  const float* __restrict__ live,         // (n,)
                  const int64_t* __restrict__ order,      // (n,) rows by node
                  const int64_t* __restrict__ offsets,    // (width + 1,)
                  const int64_t* __restrict__ tile_end,   // (width,) tiles, prefix sum
                  const long long* __restrict__ exps,     // (3,) e_c
                  unsigned long long* __restrict__ acc,   // (width, f, b, 3)
                  int f, int b, int width, int tile_rows, int f_slice) {
  extern __shared__ unsigned long long sh[];  // (f_slice, b, 3)

  const level_hist::Tile tile =
      level_hist::find_tile(offsets, tile_end, width, tile_rows);
  if (tile.node >= width) return;  // surplus tile of the static grid bound
  const int f0 = blockIdx.y * f_slice;
  const int fs = f - f0 < f_slice ? f - f0 : f_slice;
  const int cells = fs * b * 3;
  const double up0 = pow2(exps[0]), up1 = pow2(exps[1]), up2 = pow2(exps[2]);

  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = 0ull;
  __syncthreads();

  // every row of a tile has live != 0: the tile plan left the others out
  const int work = tile.rows * fs;
  for (int i = threadIdx.x; i < work; i += blockDim.x) {
    const int64_t r = order[tile.start + i / fs];
    const int fl = i % fs;
    const int bin = binned[r * f + f0 + fl];
    if (bin >= b) continue;  // out-of-range ids are the caller's bug; never write past the tile
    const float lv = live[r];
    const long long tg =
        __double2ll_rn(__dmul_rn((double)__fmul_rn(grad[r], lv), up0));
    const long long th =
        __double2ll_rn(__dmul_rn((double)__fmul_rn(hess[r], lv), up1));
    const long long tl = __double2ll_rn(__dmul_rn((double)lv, up2));
    unsigned long long* cell = sh + (fl * b + bin) * 3;
    atomicAdd(cell, (unsigned long long)tg);
    atomicAdd(cell + 1, (unsigned long long)th);
    atomicAdd(cell + 2, (unsigned long long)tl);
  }
  __syncthreads();

  // the slice's cells are contiguous in the (width, f, b, 3) buffer
  level_hist::flush_cells((const long long*)sh,
                          acc + ((int64_t)tile.node * f + f0) * b * 3, cells);
}

// The dequantization's scales: 2^-e_c.
struct InversePow2 {
  const long long* exps;
  __device__ double operator()(int c) const { return pow2(-exps[c]); }
};

}  // namespace

extern "C" {

// Launches the three kernels on `stream` (a cudaStream_t) of device
// `device`. `acc` holds width * f * b * 3 int64 sums and then 6 int64 of
// scratch (the channels' amax bits, then e_c), all zero on entry; `out` is
// the (width, f, b, 3) float32 histogram. Returns the first CUDA error: 0
// on success.
int mmls_level_hist(const void* binned, const void* grad, const void* hess,
                    const void* live, const void* order, const void* offsets,
                    const void* tile_end, void* acc, void* out, long long n,
                    int f, int b, int width, int tile_rows, int num_tiles,
                    int f_slice, int num_slices, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t cells = (int64_t)width * f * b * 3;
  unsigned long long* sums = (unsigned long long*)acc;
  unsigned long long* amax_bits = sums + cells;
  long long* exps = (long long*)(sums + cells + 3);

  amax_kernel<<<kAmaxBlocks, kAmaxThreads, 0, s>>>(
      (const float*)grad, (const float*)hess, (const float*)live, amax_bits,
      n);
  exponents_kernel<<<1, 32, 0, s>>>(amax_bits, exps, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem = f_slice * b * 3 * (int)sizeof(unsigned long long);
  err = cudaFuncSetAttribute(level_hist_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)num_tiles, (unsigned)num_slices);
  level_hist_kernel<<<grid, kThreads, smem, s>>>(
      (const uint8_t*)binned, (const float*)grad, (const float*)hess,
      (const float*)live, (const int64_t*)order, (const int64_t*)offsets,
      (const int64_t*)tile_end, exps, sums, f, b, width, tile_rows, f_slice);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)level_hist::dequantize((const long long*)sums, (float*)out,
                                     InversePow2{exps}, cells, s);
}

const char* mmls_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
