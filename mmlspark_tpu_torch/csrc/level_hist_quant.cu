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
// of `node` with live > 0 whose feature f falls in `bin`. Sums are exact
// integers, rounded to float32 once; integer adds commute, so the result is
// the same bits whatever order the rows are added in, and the fit on this
// kernel is reproducible run to run.
//
// Design. Five launches on the stream, none waiting on the host:
//   1-3. the stable counting partition by node of level_hist_common.cuh,
//      shared with level_hist.cu; this plane keeps the rows with live > 0
//      (QuantRows), and its count pass writes each row's grad_q and hess_q
//      as one packed 32-bit word (two int16 halves; int8 widened), so the
//      histogram gathers one 4-byte word per row;
//   4. the histogram, on level_hist.cu's walk. The grid is persistent
//      (kCtasPerSm CTAs per SM, by the occupancy API), the CTAs split over
//      feature slices of at most 32 features in proportion to their
//      features. Each CTA takes an equal run of the sorted kept rows and
//      stages it in chunks of kChunk rows through a ring of kStages buffers:
//      while it adds one chunk, cp.async gathers the packed words and the
//      slice's bin bytes (32-bit copies where rows are whole words) of the
//      chunks after it. One warp adds a row, a lane per feature, into the
//      CTA's int32 cells, one native 32-bit shared atomic per channel; the
//      cells of channel c sit at c * plane + bin * 32 + lane, so the 32
//      lanes of a warp always hit 32 different banks (97,920 B at B = 255,
//      half the float32 kernel's int64 cells). Where the run leaves a node
//      the CTA adds its non-zero cells, sign-extended, into the zeroed int64
//      sums with 64-bit global atomics (two's-complement adds give the exact
//      signed sum in any order) and clears them;
//   5. the elementwise dequantization (level_hist_common.cuh); in the JAX
//      package too it lies outside the Pallas body (hist_pallas.py:218-219).
//
// Bin ids: uint8_t (B <= 256) or uint16_t (B <= 65,536), a template of the
// kernel. At 384 B per bin the int32 cells of 32 lanes leave no room for a
// slice's staging past about 500 bins, so uint16 ids split the bins into
// tiles (hist_cuda.quant_plan), a grid axis of its own: each CTA of tile t
// keeps the cell layout above for its bins and skips the (row, feature)
// pairs of other tiles, as level_hist.cu does; the int64 sums stay exact.
// The uint8 instance has one tile of every bin and is the code it was.
//
// The int32 window. A cell grows by at most 2^(bits-1) per row, so it holds
// W = floor((2^31 - 1) / 2^(bits-1)) rows (q16: 65,535; q8: 16,777,215)
// without wrapping. A CTA's run in one node is not bounded by a tile (at
// N = 2M about 14k rows, but it grows with N), so the CTA also flushes once
// a node's rows since its last flush could pass W with one more chunk
// (`window`, hist_cuda.quant_window): the part the native kernel's periodic
// flush plays.
//
// What bounds it. Per level the function must read the N x F bin bytes, the
// two (N,) int16/int8 vectors, the (N,) float32 live mask and the (N,) node
// ids (int64 on the training path), and write the (width, F, B, 3) float32
// histogram: at N = 2M, F = 28 about 84-88 MB, some 26 us at the H100 SXM's
// 3.35 TB/s. The adds (3 per live row and feature) are far below the card's
// integer rate, so the bound is bytes. Over it: the partition reads the node
// ids and live twice; below the root a node's rows sit at scattered
// addresses, so a row costs a 32-byte sector of packed words and one or two
// of bin bytes; three 32-bit shared atomics per (row, feature) and the
// latency of the staging set the histogram's pace.

#include <cstdint>
#include <cuda_runtime.h>

#include "level_hist_common.cuh"

namespace {

using namespace level_hist;

// The launch configuration, measured by tools/torch_hist_quant_configs.py:
// 1,024-row chunks pay fewer barriers per row than 256 or 512 (larger ones
// lose more to filling and draining the ring below the root); a deeper
// ring, or two CTAs of 512 threads per SM in the shared memory the int32
// cells leave free, were no faster.
constexpr int kThreads = 1024;
constexpr int kCtasPerSm = 1;
constexpr int kChunk = 1024;         // rows staged at once (hist_cuda.QUANT_CHUNK_ROWS)
constexpr int kStages = 2;           // chunks in the ring (hist_cuda.QUANT_STAGES)
constexpr int kLanes = 32;           // a warp per row, a lane per feature
constexpr int kWarps = kThreads / kLanes;
constexpr int kIds = (kChunk + kThreads - 1) / kThreads;  // row ids a thread loads ahead

// The quantized plane's rows for the partition: it keeps live > 0 (the gate
// of its plain version, hist_cuda.level_histogram_quant_reference), and the
// count pass packs each row's grad_q (low half) and hess_q (high half).
template <typename Q>
struct QuantRows {
  const Q* __restrict__ grad;
  const Q* __restrict__ hess;
  unsigned* __restrict__ packed;                // (n,)

  struct Max {};
  __device__ static bool keep(float lv) { return lv > 0.f; }
  __device__ void put(int64_t r, float, Max&) const {
    packed[r] = (unsigned)(uint16_t)(int16_t)grad[r] |
                (unsigned)(uint16_t)(int16_t)hess[r] << 16;
  }
  __device__ void merge(Max&) const {}
  __device__ void finish_scan(int, int64_t) const {}
};

// The packed word's halves, sign-extended to int32.
__device__ __forceinline__ int low_half(unsigned x) { return (int)(x << 16) >> 16; }
__device__ __forceinline__ int high_half(unsigned x) { return (int)x >> 16; }

// 4. The histogram, on ids of type T, for this CTA's tile of bins.
template <typename T>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
level_hist_quant_kernel(const T* __restrict__ binned,           // (n, f) row-major
                        const unsigned* __restrict__ stats,     // (n,) packed
                        const int64_t* __restrict__ order,      // kept rows by node
                        const int64_t* __restrict__ offsets,    // (width + 1,)
                        unsigned long long* __restrict__ acc,   // (width, f, b, 3)
                        int f, int b, int width, int f_slice, int num_slices,
                        int word_bins, int window, int tile_bins) {
  constexpr bool kOneTile = sizeof(T) == 1;          // uint8: every bin at once
  extern __shared__ __align__(16) unsigned char smem[];
  // this CTA's tile of bins [t0, t0 + bt)
  const int t0 = kOneTile ? 0 : (int)blockIdx.y * tile_bins;
  const int bt = kOneTile ? b : (b - t0 < tile_bins ? b - t0 : tile_bins);
  const int plane = (kOneTile ? b : tile_bins) * kLanes;
  // staged ids per row: the slice's ids padded to whole 32-bit words
  const int ws = ((f_slice * (int)sizeof(T) + 3) & ~3) / (int)sizeof(T);
  int* cells = reinterpret_cast<int*>(smem);         // [3][bt][32]
  unsigned* sstats = reinterpret_cast<unsigned*>(cells + 3 * plane);  // [kStages][kChunk]
  int* srow = reinterpret_cast<int*>(sstats + kStages * kChunk);      // [kStages][kChunk]
  T* sbin = reinterpret_cast<T*>(srow + kStages * kChunk);  // [kStages][kChunk][ws]
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

  // its equal run [p, p_end) of the kept rows, sorted by node; chunk i
  // holds the sorted positions [p + i * kChunk, ...)
  const int64_t kept = offsets[width];
  const int64_t p = kept * (blockIdx.x - g0) / (g1 - g0);
  const int64_t p_end = kept * (blockIdx.x - g0 + 1) / (g1 - g0);
  auto rows_of = [&](int64_t i) -> int {
    const int64_t left = p_end - (p + i * kChunk);
    return left <= 0 ? 0 : (int)min64(kChunk, left);
  };

  for (int i = tid; i < 3 * plane; i += kThreads) cells[i] = 0;

  // a chunk's packed words and the slice's bin ids into ring slot `slot`
  // by cp.async; the rows' ids are in srow[slot]; a row's bin words go to
  // consecutive threads, so a warp's copies touch few sectors
  auto stage = [&](int slot, int rows) {
    const int* rid = srow + slot * kChunk;
    for (int j = tid; j < rows; j += kThreads)
      cp_async4(sstats + slot * kChunk + j, stats + rid[j]);
    T* dst = sbin + slot * kChunk * ws;
    if (word_bins) {
      const int wpr = (fs * (int)sizeof(T)) >> 2;
      for (int i = tid; i < rows * wpr; i += kThreads) {
        const int j = i / wpr, k = (i - j * wpr) * 4;
        cp_async4(reinterpret_cast<uint8_t*>(dst + j * ws) + k,
                  reinterpret_cast<const uint8_t*>(
                      binned + (int64_t)rid[j] * f + f0) + k);
      }
    } else {
      for (int i = tid; i < rows * fs; i += kThreads) {
        const int j = i / fs, k = i - j * fs;
        dst[j * ws + k] = binned[(int64_t)rid[j] * f + f0 + k];
      }
    }
  };

  // add the int32 cells into node w's int64 sums and clear them; the
  // slice's (fs, b, 3) sums are contiguous, and a tile's (bt, 3) run of
  // each feature's
  auto flush = [&](int w) {
    __syncthreads();                                 // every add has landed
    unsigned long long* dst = acc + (((int64_t)w * f + f0) * b + t0) * 3;
    for (int i = tid; i < 3 * fs * bt; i += kThreads) {
      const int c = i % 3, fl = i / 3 / bt, bin = i / 3 - fl * bt;
      int* cell = cells + c * plane + bin * kLanes + fl;
      const int v = *cell;
      if (v != 0) {
        atomicAdd(dst + (kOneTile ? i : ((int64_t)fl * b + bin) * 3 + c),
                  (unsigned long long)(long long)v);
        *cell = 0;
      }
    }
    __syncthreads();                                 // cleared before the next adds
  };

  for (int k = 0; k < kStages; ++k)                  // the first chunks' ids
    for (int j = tid; j < rows_of(k); j += kThreads)
      srow[k * kChunk + j] = (int)order[p + k * kChunk + j];
  __syncthreads();                                   // cells are zero, ids staged
  for (int k = 0; k + 1 < kStages; ++k) {
    stage(k, rows_of(k));
    cp_async_commit();
  }

  // the node of row p: the last w with offsets[w] <= p
  int w = 0;
  for (int hi = width; hi - w > 1;) {
    const int mid = (w + hi) >> 1;
    if (offsets[mid] <= p) w = mid; else hi = mid;
  }
  int since = 0;                                     // rows of node w in the cells
  int slot = 0;                                      // chunk i's ring slot
  for (int64_t i = 0;; ++i) {
    const int rows = rows_of(i);
    if (rows == 0) break;
    stage(slot == 0 ? kStages - 1 : slot - 1, rows_of(i + kStages - 1));
    cp_async_commit();                               // in flight during this chunk
    const int rows_ahead = rows_of(i + kStages);     // its ids, into registers
    const int64_t ahead = p + (i + kStages) * kChunk;
    int id_ahead[kIds];
#pragma unroll
    for (int k = 0; k < kIds; ++k) {
      const int j = tid + k * kThreads;
      id_ahead[k] = j < rows_ahead ? (int)order[ahead + j] : 0;
    }
    cp_async_wait<kStages - 1>();                    // this chunk has landed
    __syncthreads();

    const T* bins = sbin + slot * kChunk * ws + lane;
    const unsigned* words = sstats + slot * kChunk;
    const int64_t c0 = p + i * kChunk, c1 = c0 + rows;
    for (int64_t pos = c0; pos < c1;) {              // the chunk node by node
      while (offsets[w + 1] <= pos) ++w;
      const int64_t node_end = offsets[w + 1];
      const int64_t seg_end = min64(c1, node_end);
      const int j1 = (int)(seg_end - c0);
      if (lane < fs) {
        for (int j = (int)(pos - c0) + warp; j < j1; j += kWarps) {
          const int bin = (int)bins[j * ws] - t0;
          // a bin of another tile; out-of-range ids are the caller's bug:
          // never write past the slice
          if ((unsigned)bin < (unsigned)bt) {
            const unsigned x = words[j];
            int* cell = cells + bin * kLanes + lane;
            atomicAdd(cell, low_half(x));
            atomicAdd(cell + plane, high_half(x));
            atomicAdd(cell + 2 * plane, 1);
          }
        }
      }
      since += (int)(seg_end - pos);
      pos = seg_end;
      // the run leaves node w, or one more chunk could pass the window
      if (pos == node_end || pos == p_end || since > window - kChunk) {
        flush(w);
        since = 0;
      }
    }
#pragma unroll
    for (int k = 0; k < kIds; ++k) {                 // this slot is spent
      const int j = tid + k * kThreads;
      if (j < rows_ahead) srow[slot * kChunk + j] = id_ahead[k];
    }
    __syncthreads();
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
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
cudaError_t plan_quant(const void* local, int local_bytes, const void* live,
                       const void* grad, const void* hess, unsigned* packed,
                       int* wcounts, int* btot, int64_t* offsets,
                       int64_t* order, int64_t n, int width, cudaStream_t s) {
  const QuantRows<Q> rows{(const Q*)grad, (const Q*)hess, packed};
  if (local_bytes == 8)
    return plan((const int64_t*)local, (const float*)live, rows, wcounts, btot,
                offsets, order, n, width, s);
  if (local_bytes == 4)
    return plan((const int32_t*)local, (const float*)live, rows, wcounts, btot,
                offsets, order, n, width, s);
  return cudaErrorInvalidValue;
}

// The histogram launch on ids of type T: a persistent grid of gx CTAs
// per tile over the feature slices (at least one CTA per slice), and
// num_tiles tiles of tile_bins bins (one of B bins for uint8 ids).
template <typename T>
cudaError_t launch_quant(const void* binned, const void* stats,
                         const void* order, const void* offsets, void* acc,
                         int f, int b, int width, int f_slice, int num_slices,
                         int window, int tile_bins, int num_tiles, int smem,
                         int device, cudaStream_t s) {
  if (sizeof(T) == 1 ? (num_tiles != 1 || tile_bins != b)
                     : ((int64_t)tile_bins * num_tiles < b || num_tiles > 65535))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      level_hist_quant_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, level_hist_quant_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int want = (sms * per_sm + num_tiles - 1) / num_tiles;
  const int gx = want > num_slices ? want : num_slices;
  const int word_bins = (f * (int)sizeof(T)) % 4 == 0 &&
                        (f_slice * (int)sizeof(T)) % 4 == 0 &&
                        (uintptr_t)binned % 4 == 0;
  level_hist_quant_kernel<T><<<dim3(gx, num_tiles), kThreads, smem, s>>>(
      (const T*)binned, (const unsigned*)stats, (const int64_t*)order,
      (const int64_t*)offsets, (unsigned long long*)acc, f, b, width, f_slice,
      num_slices, word_bins, window, tile_bins);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the partition (three kernels), the histogram and the
// dequantization on `stream` (a cudaStream_t) of device `device`; `qbits` is
// 16 (int16 grad/hess) or 8 (int8); `binned` holds uint8 (bin_bytes 1) or
// uint16 (2) ids; `local` int32 (local_bytes 4) or int64 (8) node ids.
// Scratch, written here: `stats` n packed uint32; `counts` (width + 1) *
// (ns + nb) int32 for ns = ceil(n / 512) warp segments and nb = ceil(ns /
// 8) CTAs; `offsets` width + 1 int64; `order` n int64. `acc` holds the
// width * f * b * 3 int64 sums, zero on entry; `out` is the (width, f, b,
// 3) float32 histogram; the bins go in num_tiles tiles of tile_bins (uint8
// ids: one tile, tile_bins = b); `smem` a histogram CTA's dynamic shared
// memory (hist_cuda.quant_smem_bytes); `window` the rows of one node a
// CTA's int32 cells take between flushes (hist_cuda.quant_window). width
// must not pass 12287 (the partition's per-warp key counters), n must be
// below 2^31. Returns the first CUDA error: 0 on success.
int mmls_level_hist_quant(const void* binned, const void* grad,
                          const void* hess, const void* live,
                          const void* local, int local_bytes, void* stats,
                          void* counts, void* offsets, void* order, void* acc,
                          void* out, const void* gscale_inv,
                          const void* hscale_inv, int qbits, long long n,
                          int f, int b, int width, int f_slice,
                          int num_slices, int bin_bytes, int tile_bins,
                          int num_tiles, int smem, int window, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (width > kMaxWidth || window < kChunk || (bin_bytes != 1 && bin_bytes != 2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int* wcounts = (int*)counts;
  int* btot = wcounts + plan_wcounts(n, width);
  if (qbits == 16)
    err = plan_quant<int16_t>(local, local_bytes, live, grad, hess,
                              (unsigned*)stats, wcounts, btot,
                              (int64_t*)offsets, (int64_t*)order, n, width, s);
  else if (qbits == 8)
    err = plan_quant<int8_t>(local, local_bytes, live, grad, hess,
                             (unsigned*)stats, wcounts, btot,
                             (int64_t*)offsets, (int64_t*)order, n, width, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;

  err = bin_bytes == 1
      ? launch_quant<uint8_t>(binned, stats, order, offsets, acc, f, b, width,
                              f_slice, num_slices, window, tile_bins,
                              num_tiles, smem, device, s)
      : launch_quant<uint16_t>(binned, stats, order, offsets, acc, f, b,
                               width, f_slice, num_slices, window, tile_bins,
                               num_tiles, smem, device, s);
  if (err != cudaSuccess) return (int)err;
  return (int)dequantize(
      (const long long*)acc, (float*)out,
      InverseScales{(const float*)gscale_inv, (const float*)hscale_inv},
      (int64_t)width * f * b * 3, s);
}

const char* mmls_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
