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
// Design. Five launches on the stream, none waiting on the host (the fit's
// host syncs stay flat in the tree count):
//   1-3. the stable counting partition of the rows by node that both
//      planes share (level_hist_common.cuh), in place of a sort; this
//      plane keeps the rows with live != 0 (F32Rows). Its count pass also
//      writes each row's (grad*live, hess*live, live, 0) as one float4 and
//      the channels' amax, and its scan's tail computes e_c, the largest e
//      with n * amax_c * 2^e <= 2^62, by integer exponent arithmetic;
//   4. the histogram. The grid is persistent: one CTA of 1,024 threads per
//      SM, the CTAs split over the feature slices (at most 32 features
//      each) in proportion to their features. Each CTA of a slice takes an
//      equal run of the sorted kept rows and walks it node by node in
//      chunks of kChunk = 256 rows, double-buffered: while it adds one
//      chunk, cp.async gathers the next chunk's stats and bin bytes (32-bit
//      copies where rows are whole words) into shared memory, and the rows
//      of the chunk after that are prefetched into L2. A chunk's three
//      int64 terms per row are scaled and rounded once per row, not once
//      per feature. Then one warp adds a row, a lane per feature, into the
//      CTA's int64 cells in shared memory: each cell is two 32-bit words
//      added by two native 32-bit atomics with a carry (add64), and the
//      words of (bin, feature) sit at bin * 32 + feature, so the 32 lanes
//      of a warp always hit 32 different banks (195,840 B at B = 255). The
//      CTA flushes its cells into the zeroed int64 sums with 64-bit global
//      atomics, clearing them as it goes, only where its run leaves a node:
//      about (SMs + width) flushes per slice and level, where a CTA per
//      4,096-row tile made n / 4,096 + width;
//   5. the elementwise dequantization (level_hist_common.cuh).
//
// What bounds it. Per level the function must read the N x F bin bytes,
// the three (N,) float32 vectors and the (N,) node ids (int64 on the
// training path), and write the float32 histogram: at N = 2M, F = 28 about
// 96 MB, some 29 us at the H100 SXM's 3.35 TB/s. The arithmetic (3 scaled
// adds per live row and feature) is far below the card's rate, so the bound
// is bytes. Over it: the partition reads the node ids and live twice;
// below the root a node's rows sit at scattered addresses, so a row costs
// a 32-byte sector of stats and one or two of bin bytes; and six 32-bit
// shared atomics per (row, feature), one wavefront each, set the
// histogram's pace.

#include <cstdint>
#include <cuda_runtime.h>

#include "level_hist_common.cuh"

namespace {

using namespace level_hist;

constexpr int kThreads = 1024;       // one CTA per SM: its cells fill shared memory
constexpr int kLanes = 32;           // a warp per row, a lane per feature
constexpr int kChunk = 256;          // rows staged at once (hist_cuda.CHUNK_ROWS)

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
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

// The float32 plane's rows for the partition (level_hist_common.cuh): it
// keeps live != 0; the count pass writes each row's (grad*live, hess*live,
// live, 0) to stats[r] as one float4 (so the histogram gathers one 16-byte
// value per row, not three scattered floats), and every warp merges its
// maxima of their magnitudes into amax_bits by integer atomicMax on the
// float bits (non-negative floats order as their bits; amax_bits zeroed);
// the scan's tail turns them into e_c.
struct F32Rows {
  const float* __restrict__ grad;
  const float* __restrict__ hess;
  float4* __restrict__ stats;
  unsigned long long* __restrict__ amax_bits;   // (3,)
  long long* __restrict__ exps;                 // (3,) e_c

  struct Max {
    float g = 0.f, h = 0.f, l = 0.f;
  };
  __device__ static bool keep(float lv) { return lv != 0.f; }
  __device__ void put(int64_t r, float lv, Max& m) const {
    const float4 x = make_float4(__fmul_rn(grad[r], lv),
                                 __fmul_rn(hess[r], lv), lv, 0.f);
    stats[r] = x;
    m.g = fmaxf(m.g, fabsf(x.x));
    m.h = fmaxf(m.h, fabsf(x.y));
    m.l = fmaxf(m.l, fabsf(lv));
  }
  __device__ void merge(Max& m) const {
    const float g = warp_max(m.g), h = warp_max(m.h), l = warp_max(m.l);
    if ((threadIdx.x & 31) == 0) {
      atomicMax(amax_bits, (unsigned long long)__float_as_uint(g));
      atomicMax(amax_bits + 1, (unsigned long long)__float_as_uint(h));
      atomicMax(amax_bits + 2, (unsigned long long)__float_as_uint(l));
    }
  }
  __device__ void finish_scan(int tid, int64_t n) const {
    if (tid < 3)
      exps[tid] = fixed_point_exponent(__uint_as_float((unsigned)amax_bits[tid]), n);
  }
};

// 2^k as a double, built from its bits (|k| <= 1022 here: e_c lies in
// [-106, 234] for any finite float data).
__device__ __forceinline__ double pow2(long long k) {
  return __longlong_as_double((k + 1023) << 52);
}

__device__ __forceinline__ long long term(float x, double up) {
  return __double2ll_rn(__dmul_rn((double)x, up));
}

// A 64-bit add into a cell held as two 32-bit words in separate planes,
// with two native 32-bit shared atomics: the low word returns its old value
// to give the carry, which goes into the high word with the term's high
// half. The words end as the exact 64-bit sum (two's complement, mod
// 2^64), in any order of the adds. (A 64-bit shared atomicAdd is a CAS
// loop on sm_90, ATOMS.CAST.SPIN.64, at about half the rate.)
__device__ __forceinline__ void add64(unsigned* lo, unsigned* hi, long long t) {
  const unsigned tl = (unsigned)t;
  const unsigned old = atomicAdd(lo, tl);
  const unsigned th = (unsigned)(t >> 32) + (old + tl < old ? 1u : 0u);
  if (th) atomicAdd(hi, th);
}

// A run of at most kChunk sorted rows [c0, c0 + rows) of one node w.
struct Chunk {
  int64_t c0;
  int rows;     // 0: the CTA's run is done
  int w;
};

// The chunk after `c`: the rest of node c.w's rows in the run, else the
// first rows of the next node that has some.
__device__ __forceinline__ Chunk next_chunk(Chunk c, int64_t p_end,
                                            const int64_t* __restrict__ offsets) {
  Chunk n{c.c0 + c.rows, 0, c.w};
  if (c.rows == 0 || n.c0 >= p_end) return n;
  while (offsets[n.w + 1] <= n.c0) ++n.w;
  n.rows = (int)min64(kChunk, min64(p_end, offsets[n.w + 1]) - n.c0);
  return n;
}

// 4. The histogram.
__global__ void __launch_bounds__(kThreads, 1)
level_hist_kernel(const uint8_t* __restrict__ binned,     // (n, f) row-major
                  const float4* __restrict__ stats,       // (n,) from plan_count
                  const int64_t* __restrict__ order,      // kept rows by node
                  const int64_t* __restrict__ offsets,    // (width + 1,)
                  const long long* __restrict__ exps,     // (3,) e_c
                  unsigned long long* __restrict__ acc,   // (width, f, b, 3)
                  int f, int b, int width, int f_slice, int num_slices,
                  int word_bins) {
  extern __shared__ __align__(16) unsigned char smem[];
  // cell (feature fl, bin, channel c) of the slice: low word at
  // cells[2c * plane + bin * 32 + fl], high word one plane further; a
  // warp's lanes (its features) always hit 32 different banks
  const int plane = b * kLanes;
  const int ws = (f_slice + 3) & ~3;                 // staged bytes per row
  unsigned* cells = reinterpret_cast<unsigned*>(smem);
  float4* sstats = reinterpret_cast<float4*>(cells + 6 * plane);   // [2][kChunk]
  long long* sterm = reinterpret_cast<long long*>(sstats + 2 * kChunk);  // [kChunk][4]
  uint8_t* sbin = reinterpret_cast<uint8_t*>(sterm + 4 * kChunk);  // [2][kChunk][ws]
  int64_t* srow = reinterpret_cast<int64_t*>(sbin + 2 * kChunk * ws);  // [2][kChunk]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // this CTA's feature slice: slice s owns CTAs [T*s*f_slice/f, ...), a
  // share of the grid in proportion to its features
  const long long grid = gridDim.x;
  int s = 0;
  while (s + 1 < num_slices && grid * (s + 1) * f_slice / f <= blockIdx.x) ++s;
  const long long g0 = grid * s * f_slice / f;
  const long long g1 = s + 1 < num_slices ? grid * (s + 1) * f_slice / f : grid;
  const int f0 = s * f_slice;
  const int fs = f - f0 < f_slice ? f - f0 : f_slice;

  // its equal run [p, p_end) of the kept rows, sorted by node
  const int64_t kept = offsets[width];
  const int64_t p = kept * (blockIdx.x - g0) / (g1 - g0);
  const int64_t p_end = kept * (blockIdx.x - g0 + 1) / (g1 - g0);
  const double up0 = pow2(exps[0]), up1 = pow2(exps[1]), up2 = pow2(exps[2]);

  for (int i = tid; i < 6 * plane; i += kThreads) cells[i] = 0u;
  // the node of row p: the last w with offsets[w] <= p
  int w0 = 0;
  for (int hi = width; hi - w0 > 1;) {
    const int mid = (w0 + hi) >> 1;
    if (offsets[mid] <= p) w0 = mid; else hi = mid;
  }
  Chunk cur{p, 0, w0};
  if (p < p_end)
    cur.rows = (int)min64(kChunk, min64(p_end, offsets[w0 + 1]) - p);
  Chunk nxt = next_chunk(cur, p_end, offsets);

  // a chunk's (grad*live, hess*live, live) and the slice's bin bytes into
  // shared memory by cp.async: the rows' ids are in srow[buf]; a row's bin
  // words go to consecutive threads, so a warp's copies touch few sectors
  auto stage = [&](int buf, int rows) {
    const int64_t* rid = srow + buf * kChunk;
    if (tid < rows) cp_async16(sstats + buf * kChunk + tid, stats + rid[tid]);
    uint8_t* dst = sbin + buf * kChunk * ws;
    if (word_bins) {
      const int wpr = fs >> 2;
      for (int i = tid; i < rows * wpr; i += kThreads) {
        const int j = i / wpr, k = (i - j * wpr) * 4;
        cp_async4(dst + j * ws + k, binned + rid[j] * f + f0 + k);
      }
    } else {
      for (int i = tid; i < rows * fs; i += kThreads) {
        const int j = i / fs, k = i - j * fs;
        dst[j * ws + k] = binned[rid[j] * f + f0 + k];
      }
    }
  };
  if (tid < cur.rows) srow[tid] = order[cur.c0 + tid];
  if (tid < nxt.rows) srow[kChunk + tid] = order[nxt.c0 + tid];
  __syncthreads();                                   // cells are zero, ids staged
  stage(0, cur.rows);
  cp_async_commit();

  for (int buf = 0; cur.rows > 0; buf ^= 1) {
    const Chunk after = next_chunk(nxt, p_end, offsets);
    stage(buf ^ 1, nxt.rows);                        // in flight during this chunk
    cp_async_commit();
    const int64_t r_after = tid < after.rows ? order[after.c0 + tid] : 0;
    cp_async_wait<1>();                              // this chunk has landed
    __syncthreads();
    if (tid < cur.rows) {                            // the rows' terms, once
      const float4 x = sstats[buf * kChunk + tid];
      sterm[tid * 4] = term(x.x, up0);
      sterm[tid * 4 + 1] = term(x.y, up1);
      sterm[tid * 4 + 2] = term(x.z, up2);
    }
    __syncthreads();
    if (lane < fs) {
      const uint8_t* bins = sbin + buf * kChunk * ws + lane;
      for (int j = warp; j < cur.rows; j += kThreads / kLanes) {
        const int bin = bins[j * ws];
        if (bin < b) {  // out-of-range ids are the caller's bug; never write past the slice
          const longlong2 gh = reinterpret_cast<const longlong2*>(sterm)[j * 2];
          const long long tl = sterm[j * 4 + 2];
          unsigned* cell = cells + bin * kLanes + lane;
          add64(cell, cell + plane, gh.x);
          add64(cell + 2 * plane, cell + 3 * plane, gh.y);
          add64(cell + 4 * plane, cell + 5 * plane, tl);
        }
      }
    }
    if (nxt.rows == 0 || nxt.w != cur.w) {
      // the run leaves node cur.w: add its cells into the int64 sums, where
      // the slice's (fs, b, 3) cells are contiguous, and clear them
      __syncthreads();
      unsigned long long* dst = acc + ((int64_t)cur.w * f + f0) * b * 3;
      for (int i = tid; i < 3 * fs * b; i += kThreads) {
        const int c = i % 3, fl = i / 3 / b, bin = i / 3 - fl * b;
        unsigned* lo = cells + 2 * c * plane + bin * kLanes + fl;
        const unsigned long long v =
            (unsigned long long)lo[plane] << 32 | lo[0];
        if (v != 0) {
          atomicAdd(dst + i, v);
          lo[0] = lo[plane] = 0u;
        }
      }
    }
    if (tid < after.rows) srow[buf * kChunk + tid] = r_after;  // this chunk's ids are spent
    __syncthreads();
    cur = nxt;
    nxt = after;
  }
}

// The dequantization's scales: 2^-e_c.
struct InversePow2 {
  const long long* exps;
  __device__ double operator()(int c) const { return pow2(-exps[c]); }
};

}  // namespace

extern "C" {

// Launches the partition (three kernels), the histogram and the
// dequantization on `stream` (a cudaStream_t) of device `device`. `local`
// holds int32 (local_bytes 4) or int64 (8) node ids. Scratch, written
// here: `stats` (n, 4) float32; `counts` (width + 1) * (ns + nb) int32
// for ns = ceil(n / 512) warp segments and nb = ceil(ns / 8) CTAs (the
// per-warp counts, then the per-CTA places); `offsets` width + 1 int64;
// `order` n int64. `acc` holds width * f * b * 3 int64 sums and then 6
// int64 (the channels' amax bits, then e_c), all zero on entry; `out` is
// the (width, f, b, 3) float32 histogram; `smem` a histogram CTA's dynamic
// shared memory (hist_cuda.f32_smem_bytes). width must be below 12288 (the
// partition's per-warp key counters). Returns the first CUDA error: 0 on
// success.
int mmls_level_hist(const void* binned, const void* grad, const void* hess,
                    const void* live, const void* local, int local_bytes,
                    void* stats, void* counts, void* offsets, void* order,
                    void* acc, void* out, long long n, int f, int b,
                    int width, int f_slice, int num_slices, int smem,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t cells = (int64_t)width * f * b * 3;
  unsigned long long* sums = (unsigned long long*)acc;
  unsigned long long* amax_bits = sums + cells;
  long long* exps = (long long*)(sums + cells + 3);
  int* wcounts = (int*)counts;
  int* btot = wcounts + plan_wcounts(n, width);
  const F32Rows rows{(const float*)grad, (const float*)hess, (float4*)stats,
                     amax_bits, exps};

  if (local_bytes == 8)
    err = plan((const int64_t*)local, (const float*)live, rows, wcounts, btot,
               (int64_t*)offsets, (int64_t*)order, n, width, s);
  else if (local_bytes == 4)
    err = plan((const int32_t*)local, (const float*)live, rows, wcounts, btot,
               (int64_t*)offsets, (int64_t*)order, n, width, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(level_hist_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, level_hist_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = sms * per_sm > num_slices ? sms * per_sm : num_slices;
  const int word_bins = f % 4 == 0 && f_slice % 4 == 0 &&
                        (uintptr_t)binned % 4 == 0;
  level_hist_kernel<<<grid, kThreads, smem, s>>>(
      (const uint8_t*)binned, (const float4*)stats, (const int64_t*)order,
      (const int64_t*)offsets, exps, sums, f, b, width, f_slice, num_slices,
      word_bins);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)level_hist::dequantize((const long long*)sums, (float*)out,
                                     InversePow2{exps}, cells, s);
}

const char* mmls_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
